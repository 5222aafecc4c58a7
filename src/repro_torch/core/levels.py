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

from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

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


class Peeled(NamedTuple):
    """A call's tensors below its outermost ``vmap`` levels.

    ``tensors``: what lies below those levels (a plain tensor, one that
    requires grad, or a tensor of an inner ``grad`` level); ``levels``:
    one ``(level, batch size, dims)`` a peeled level, outermost first,
    ``dims`` holding each tensor's batch dim at that level (None where the
    tensor is not batched there).  A level's id differs from one
    ``torch.func.vmap`` call to the next; :meth:`structure` is what a
    plan guards."""
    tensors: List[torch.Tensor]
    levels: Tuple[Tuple[int, int, Tuple[Optional[int], ...]], ...]

    def structure(self) -> Tuple:
        """Each peeled level's batch size and batch dims (outermost
        first), and each tensor's shape and strides below the levels."""
        return (tuple((b, dims) for _, b, dims in self.levels),
                tuple((tuple(t.shape), t.stride()) for t in self.tensors))


def peel(tensors: Sequence[torch.Tensor]) -> Peeled:
    """Take every ``vmap`` level above the call's outermost level of any
    other kind off ``tensors``, outermost first: a nested ``vmap`` gives
    two levels, ``torch.func.grad`` outside a ``vmap`` leaves the grad
    level on the tensors below, ``vmap`` outside ``grad`` (a grad level
    outermost) peels nothing.  :func:`program` rebuilds the call on the
    tensors below, :func:`rewrap` its outputs."""
    ts = list(tensors)
    vmaps, other = set(), -1
    for t in ts:
        for w in layers(t):
            lv = F.maybe_get_level(w)
            if F.is_batchedtensor(w):
                vmaps.add(lv)
            else:
                other = max(other, lv)
    peeled = []
    for level in sorted((lv for lv in vmaps if lv > other), reverse=True):
        dims, size = [], 0
        for i, t in enumerate(ts):
            if F.is_batchedtensor(t) and F.maybe_get_level(t) == level:
                ts[i], d = F._unwrap_batched(t, level)
                size = ts[i].shape[d]
                dims.append(d)
            else:
                dims.append(None)
        peeled.append((level, size, tuple(dims)))
    return Peeled(ts, tuple(peeled))


def program(fn: Callable, levels: Sequence[Tuple]) -> Callable:
    """``fn`` of the per-element tensors as a function of the tensors
    below ``levels`` (:func:`peel`'s): one ``torch.func.vmap`` a level,
    the outermost level's innermost, every output batched at dim 0 of each
    level (the innermost peeled level's first)."""
    for _, _, dims in levels:
        fn = torch.func.vmap(fn, in_dims=tuple(dims))
    return fn


def rewrap(outs: List[Any], levels: Sequence[Tuple]) -> List[Any]:
    """:func:`program`'s outputs wrapped back at the caller's ``levels``,
    innermost first: the per-element values the call returns."""
    ids = [lv for lv, _, _ in levels][::-1]

    def wrap(o):
        if not isinstance(o, torch.Tensor):
            return o
        for lv in ids:
            o = F._add_batch_dim(o, 0, lv)
        return o

    return [wrap(o) for o in outs]


def map_outer(fn: Callable[[List[Any]], Any], leaves: Sequence[Any]):
    """``fn(leaves)`` once an element of the ``vmap`` level outermost
    among ``leaves``' tensors, the results stacked and wrapped back at
    that level (a pytree of tensors), as a loop over the batch would give
    them: no batching rule of ``fn``'s own runs at that level.  None when
    no tensor carries a ``vmap`` level outermost, or a ``grad`` level
    lies above it (its elements cannot be taken apart)."""
    from torch.utils._pytree import tree_map

    outer = [(F.maybe_get_level(t), F.is_batchedtensor(t)) for t in leaves
             if isinstance(t, torch.Tensor)
             and F.is_functorch_wrapped_tensor(t)]
    if not outer:
        return None
    level = max(lv for lv, _ in outer)
    if not all(b for lv, b in outer if lv == level):
        return None
    size, parts = 0, []
    for t in leaves:
        if isinstance(t, torch.Tensor) and F.is_batchedtensor(t) \
                and F.maybe_get_level(t) == level:
            t, d = F._unwrap_batched(t, level)
            size = t.shape[d]
            parts.append((t, d))
        else:
            parts.append((t, None))
    outs = [fn([t if d is None else t.select(d, i) for t, d in parts])
            for i in range(size)]
    return tree_map(lambda *xs: F._add_batch_dim(torch.stack(xs), 0, level),
                    *outs)
