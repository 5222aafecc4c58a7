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
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

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
