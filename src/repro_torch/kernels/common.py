"""Helpers shared by the kernel packages.

Counterpart of ``repro.kernels.common``.  ``apply_epilogue_inregister``
has two forms: this plain torch function, and the ``__device__`` function
``epilogue_inregister`` in each CUDA source, which applies the same chain
to the accumulator before the kernel's single store.  ``EPILOGUE_CODES``
is the integer a wrapper passes for the chain; ``check_tensor`` and
``launched`` are the checks every kernel wrapper makes around a launch;
``vmap_over_vectors`` and ``vmap_by_loop`` are the custom ops'
``torch.func.vmap`` rules.  The Mosaic-only
``compiler_params`` has no counterpart: a CUDA kernel's launch shape is set
by its wrapper.  ``COUNTERS`` holds every kernel's launch counter.

**Differentiating a custom op under every transform.**  A
``torch.library`` custom op's ``register_autograd`` formula serves
``.backward()`` only: under a ``torch.func`` grad level torch refuses it
(its generated ``autograd.Function`` has no ``setup_context``), and a
Python autograd kernel at the dispatcher cannot take its place, since
``torch.func`` dispatches an ``autograd.Function`` before the
dispatcher.  So each custom op also has a differentiable call
(:func:`differentiable`): the op inside an ``autograd.Function`` with
``setup_context`` and a generated vmap rule, whose backward is the op's
formula, taken whenever a tensor argument carries gradients at any level.
A graph that runs under differentiation has its custom-op nodes
retargeted to these calls (:func:`differentiable_graph`).  And
``torch.func.functionalize`` (the level ``make_fx`` traces a program
under, as ``lilac.compile`` does) has no rule for an
``autograd.Function`` (torch raises "NYI: Functionalize rule for
custom_function_call"): :func:`_functionalize_custom_function` supplies
the plain one, since these Functions mutate nothing, so that a compiled
gradient traces through them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch._C import _functorch as _F

#: Every kernel module's launch counter (its ``LAUNCHES``), registered by
#: :func:`counter`: an executable plan reads them around a CUDA-graph
#: capture and adds each replay's launches.
COUNTERS: List[Dict[str, int]] = []


def counter(names: Iterable[str]) -> Dict[str, int]:
    """A registered launch counter: kernel name -> launches (a plain
    count)."""
    launches = dict.fromkeys(names, 0)
    COUNTERS.append(launches)
    return launches


#: epilogue name -> the code the CUDA kernels take ('none' = bias only).
EPILOGUE_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2}


def apply_epilogue_inregister(acc: torch.Tensor, bias, epilogue: Optional[str]):
    """The epilogue: bias add then activation ('relu' | 'silu'; 'none' or
    None is bias only).  ``repro_torch.core.rewrite.apply_epilogue`` is this
    function, so the fused and unfused realizations cannot drift apart."""
    if bias is not None:
        acc = acc + bias
    if epilogue == "relu":
        acc = torch.clamp_min(acc, 0)
    elif epilogue == "silu":
        acc = acc * torch.sigmoid(acc)
    return acc


def vmap_by_loop(op, info, in_dims, args):
    """A ``register_vmap`` rule's fallback: ``op`` once per batch element
    (a batched matrix, bias or routing table: one launch an element),
    stacked on a leading batch axis."""
    outs = [op(*(a.select(d, i) if d is not None else a
                 for a, d in zip(args, in_dims)))
            for i in range(info.batch_size)]
    return torch.stack(outs), 0


def vmap_over_vectors(op, info, in_dims, args, pos: int):
    """The ``register_vmap`` rule of an SpMV custom op whose argument
    ``pos`` is the vector and which takes a batch of them ``(B, cols)``:
    with only the vector batched, one call on the batch (the kernel's batch
    axis: one launch); with anything else batched, one call an element.
    A vector batched twice (nested vmaps) is flattened into one batch."""
    if any(d is not None for i, d in enumerate(in_dims) if i != pos):
        return vmap_by_loop(op, info, in_dims, args)
    vec = args[pos].movedim(in_dims[pos], 0)
    lead = vec.shape[:-1]
    a = list(args)
    a[pos] = vec.reshape(-1, vec.shape[-1]).contiguous()
    out = op(*a)
    return out.reshape(lead + out.shape[-1:]), 0


def check_tensor(name: str, t, device, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    (and of ``shape``, when given)."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launched(launches: dict, name: str, err: int) -> None:
    """Raise if the launch of kernel ``name`` returned a CUDA error; count
    it in ``launches`` otherwise."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1


#: custom op overload -> its differentiable call (:func:`differentiable`)
DIFFERENTIABLE: Dict[Any, Callable] = {}


def carries_grad(args) -> bool:
    """Whether grad mode is on and a tensor of ``args`` requires grad at
    any ``torch.func`` level (a batched tensor over one that requires grad
    reports ``requires_grad`` False itself)."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        while isinstance(a, torch.Tensor):
            if a.requires_grad:
                return True
            if not _F.is_functorch_wrapped_tensor(a):
                break
            a = _F.get_unwrapped(a)
    return False


def differentiable(op, setup_context: Callable, backward: Callable,
                   batch: Callable) -> Callable:
    """The call of custom op ``op`` that differentiates under
    ``.backward()``, ``torch.func.grad`` and ``torch.func.vmap`` alike:
    the op itself when no argument carries gradients, else the op inside
    an ``autograd.Function`` whose ``setup_context`` and ``backward`` are
    the op's formula (the one ``register_autograd`` gives it too).
    ``batch(fn, info, in_dims, *args)`` is the op's vmap rule with ``fn``
    in the op's place: the Function batches by it with this call in the
    op's place, so a batch is one call (one launch) at the level below,
    and the backward sees the whole batch there too (the MoE formula reads
    the largest expert load of all the tokens, not a per-sequence
    bound)."""
    name = op._name.split("::")[-1]

    def call(*args):
        if carries_grad(args):
            return fn.apply(*args)
        return op(*args)

    fn = type(f"{name}_grad", (torch.autograd.Function,), {
        "forward": staticmethod(lambda *args: op(*args)),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
        "vmap": staticmethod(
            lambda info, in_dims, *args: batch(call, info, in_dims, *args)),
    })
    call.__name__ = call.__qualname__ = f"{name}_call"
    DIFFERENTIABLE[op._opoverload] = call
    return call


def differentiable_graph(gm):
    """A copy of ``gm`` whose custom-op nodes call the ops' differentiable
    calls (``DIFFERENTIABLE``): the graph a call that carries gradients
    runs, under ``.backward()`` or a ``torch.func`` grad level."""
    import copy

    from torch.fx import GraphModule

    if not any(n.op == "call_function" and n.target in DIFFERENTIABLE
               for n in gm.graph.nodes):
        return gm
    graph = copy.deepcopy(gm.graph)
    for n in graph.nodes:
        if n.op == "call_function" and n.target in DIFFERENTIABLE:
            n.target = DIFFERENTIABLE[n.target]
    return GraphModule(gm, graph)


def epilogue_cotangent(z: torch.Tensor, ct: torch.Tensor,
                       epilogue: Optional[str]) -> torch.Tensor:
    """The cotangent of the pre-activation ``z`` given the output's:
    ``relu``'s and ``silu``'s derivative (``torch.clamp_min``'s at 0)."""
    if epilogue == "relu":
        return ct * (z >= 0)
    if epilogue == "silu":
        sg = torch.sigmoid(z)
        return ct * (sg * (1 + z * (1 - sg)))
    return ct


def _functionalize_custom_function(interpreter, function, *operands):
    """``torch.func.functionalize``'s rule for an ``autograd.Function``
    (torch's own raises "NYI"): the operands' functional wrappers taken
    off, the Function applied at the level below, its outputs wrapped
    again.  Right for a Function that mutates none of its operands, as
    the port's (its custom ops' and ``rewrite.HarnessCall``) do not."""
    from torch._functorch.autograd_function import custom_function_call
    from torch._subclasses.functional_tensor import FunctorchFunctionalizeAPI

    api = FunctorchFunctionalizeAPI(interpreter)
    inner = api.unwrap_tensors(operands)
    with api.redispatch_to_next():
        out = custom_function_call(function, *inner)
    return api.wrap_tensors(out)


def _register_functionalize_rule() -> None:
    from torch._C._functorch import TransformType
    from torch._functorch.autograd_function import custom_function_call

    table = custom_function_call.functorch_table
    rule = table.get(TransformType.Functionalize)
    if rule is None or getattr(rule, "__name__", "") == \
            "custom_function_call_functionalize":
        table[TransformType.Functionalize] = _functionalize_custom_function


_register_functionalize_rule()
