"""The ``torch.func`` levels a value carries.

A tensor seen inside ``torch.func.vmap`` or ``torch.func.grad`` is a
wrapper around the tensor of the level below: a ``BatchedTensor`` shows
the per-element shape and hides its batch axis, a grad-tracking tensor
records the transform's gradient.  The pass treats the two apart: a
batched value has no per-element data that a repack, a fingerprint or a
validator could read, and a grad level carries gradients.  Wrappers nest
in the order the transforms were entered (``vmap(grad(f))`` gives a grad
wrapper around a batched one), so every question here walks all of them.
:func:`per_element` runs a body that must read data once an element of
the outermost ``vmap`` level, as a batching rule's loop would.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple, Union

import torch
from torch._C import _functorch as F


def layers(v: Any) -> Iterator[torch.Tensor]:
    """The ``torch.func`` wrappers of ``v``, outermost first."""
    while isinstance(v, torch.Tensor) and F.is_functorch_wrapped_tensor(v):
        yield v
        v = F.get_unwrapped(v)


def base(v: Any) -> Any:
    """``v`` with every ``torch.func`` wrapper removed."""
    while isinstance(v, torch.Tensor) and F.is_functorch_wrapped_tensor(v):
        v = F.get_unwrapped(v)
    return v


def batched(v: Any) -> bool:
    """Whether ``v`` carries a ``vmap`` level."""
    return any(F.is_batchedtensor(w) for w in layers(v))


def outer_batched(v: Any) -> bool:
    """Whether ``v``'s outermost ``torch.func`` level is a ``vmap``
    level."""
    return isinstance(v, torch.Tensor) and F.is_batchedtensor(v)


def only_batched(v: Any) -> bool:
    """Whether every ``torch.func`` level of ``v`` is a ``vmap`` level (a
    plain tensor has none)."""
    return all(F.is_batchedtensor(w) for w in layers(v))


def requires_grad(v: Any) -> bool:
    """Whether ``v`` carries gradients at any level: a batched tensor over
    one that requires grad reports ``requires_grad`` False itself."""
    return isinstance(v, torch.Tensor) and (
        any(w.requires_grad for w in layers(v)) or base(v).requires_grad)


def grad_state(v: torch.Tensor) -> Union[bool, Tuple]:
    """What a call's key records of a tensor leaf besides its shape, dtype
    and device: ``requires_grad`` for a plain tensor; for a wrapped one the
    kinds of its levels (outermost first) and whether any carries
    gradients, so that a vmapped or grad-transformed call keys apart from a
    plain call of the same per-element shapes."""
    if not F.is_functorch_wrapped_tensor(v):
        return v.requires_grad
    kinds = tuple("vmap" if F.is_batchedtensor(w) else
                  "grad" if F.is_gradtrackingtensor(w) else "func"
                  for w in layers(v))
    return kinds + (requires_grad(v),)


def per_element(fn: Callable[[Dict[str, Any]], torch.Tensor],
                binding: Dict[str, Any], key: str) -> torch.Tensor:
    """``fn(binding)`` once for each element of the ``vmap`` level that
    batches ``binding[key]`` at its outermost layer: each value batched at
    that level is replaced by its element, the others pass unchanged, and
    the results are stacked and wrapped back at that level.  For a body
    that reads its operand's data (a repack), which a batched tensor does
    not expose."""
    level = F.maybe_get_level(binding[key])

    def element(v, i):
        if isinstance(v, torch.Tensor) and F.is_batchedtensor(v) \
                and F.maybe_get_level(v) == level:
            t, d = F._unwrap_batched(v, level)
            return t.select(d, i)
        return v

    t, d = F._unwrap_batched(binding[key], level)
    outs = [fn({k: element(v, i) for k, v in binding.items()})
            for i in range(t.shape[d])]
    return F._add_batch_dim(torch.stack(outs), 0, level)


def batch_size(values) -> int:
    """How many per-element calls a call on ``values`` stands for: the
    product of the sizes of the distinct ``vmap`` levels among them (1
    for plain tensors)."""
    sizes: Dict[int, int] = {}
    for v in values:
        for w in layers(v):
            if F.is_batchedtensor(w):
                level = F.maybe_get_level(w)
                t, d = F._unwrap_batched(w, level)
                sizes[level] = t.shape[d]
    n = 1
    for s in sizes.values():
        n *= s
    return n
