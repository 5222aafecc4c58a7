"""The port's collectives over a ``DeviceMesh``'s named axes, as autograd
Functions on local tensors (the counterparts of ``jax.lax.all_gather``,
``psum_scatter``, ``psum`` and ``axis_index`` inside ``shard_map``).

Gradient convention.  On a mesh every rank holds local tensors, and the
objective that backward differentiates is the SUM of the ranks' local
objectives (``Model.loss_fn`` scales each rank's share so that the sum
is the one-device loss).  Each collective's backward is its adjoint under
that sum:

  all_gather      -> reduce-scatter of the cotangents
  reduce_scatter  -> all-gather
  psum            -> psum (every rank's output depends on every input)
  pair_halves     -> the inverse all-to-all

and a local slice of a replicated tensor has the zero-padding backward
that autograd gives it.  So an activation's gradient on one rank may be a
partial sum, and a weight that a rank holds replicated over a mesh axis
gets a partial gradient there: ``train.train_step`` sums each gradient
over the axes its storage does not shard, once a step (the reference's
gradient constraint).  A weight sharded over "data" (FSDP) reaches the
compute through ``all_gather``, whose backward reduce-scatters its
gradient back to the storage sharding.  Tensor parallelism needs no f/g
operator pair under this convention: a row-parallel output is ``psum``ed
(or ``reduce_scatter``ed on the sequence dim under sequence parallelism),
and the partial gradients of the replicated activations are summed where
they reach a replicated weight.

The current mesh is set with ``use_mesh`` (the counterpart of the
reference's ambient mesh).  A mesh's device type says where its process
group computes: a gloo mesh is a CPU mesh, and a CUDA operand is copied
to the host for the collective and back (explicitly, every call; that is
how several ranks share one card).  ``STATS`` counts each kind's calls
and payload bytes in this process, ``BY_AXIS`` the same by mesh axis.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.spec import pspec_axes

_MESHES: list = []

#: calls and payload bytes by kind, in this process (reset_stats zeroes)
STATS: Dict[str, Dict[str, int]] = {}
#: the same by mesh axis: {axis: {kind: {"calls", "bytes"}}}
BY_AXIS: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_stats() -> None:
    STATS.clear()
    BY_AXIS.clear()


def _count(kind: str, x: torch.Tensor, axis: str) -> None:
    for s in (STATS.setdefault(kind, {"calls": 0, "bytes": 0}),
              BY_AXIS.setdefault(axis, {}).setdefault(
                  kind, {"calls": 0, "bytes": 0})):
        s["calls"] += 1
        s["bytes"] += x.numel() * x.element_size()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh of the models' mesh path."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    if not _MESHES:
        raise RuntimeError("the mesh path needs a mesh: wrap the call in "
                           "`with collectives.use_mesh(mesh):`")
    return _MESHES[-1]


def _axes(axis) -> Tuple[str, ...]:
    """One axis name or a tuple of them, restricted to the current
    mesh's axes, major first."""
    names = current_mesh().mesh_dim_names
    return tuple(a for a in pspec_axes(axis) if a in names)


def axis_size(axis) -> int:
    mesh = current_mesh()
    n = 1
    for a in _axes(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(axis) -> int:
    """This rank's coordinate on ``axis`` (a tuple of axes: the linear
    index, the first axis the major one)."""
    mesh = current_mesh()
    i = 0
    for a in _axes(axis):
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return i


# -- one mesh axis, no autograd ---------------------------------------------

def _staged(fn, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``fn(x_on_mesh_device, group)`` with a CUDA operand copied to a CPU
    mesh's host through a page-locked buffer and the result back (``fn``
    may allocate its result page-locked, as ``xs.is_pinned()`` says)."""
    mesh = current_mesh()
    group = mesh.get_group(axis)
    if x.device.type == mesh.device_type:
        return fn(x.contiguous(), group)
    xs = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    return fn(xs, group).to(x.device, non_blocking=True)


def _gather1(x, axis: str, dim: int):
    """The ranks' blocks gathered into one buffer along dim 0, then laid
    out along ``dim`` on the operand's device."""
    n = axis_size(axis)
    if n == 1:
        return x
    _count("all_gather", x, axis)

    def run(xs, group):
        out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device,
                          pin_memory=xs.is_pinned())
        dist.all_gather_into_tensor(out, xs, group=group)
        return out
    out = _staged(run, x, axis)
    return torch.cat(out.chunk(n), dim) if dim else out


def _reduce1(x, axis: str, op=dist.ReduceOp.SUM):
    if axis_size(axis) == 1:
        return x
    _count("all_reduce", x, axis)

    def run(xs, group):
        y = xs.clone()
        dist.all_reduce(y, op=op, group=group)
        return y
    return _staged(run, x, axis)


def _scatter1(x, axis: str, dim: int):
    n = axis_size(axis)
    if n == 1:
        return x
    _count("reduce_scatter", x, axis)
    i = axis_index(axis)
    chunk = x.shape[dim] // n

    def run(xs, group):
        if dist.get_backend(group) == "nccl":
            src = xs.movedim(dim, 0).contiguous()
            out = src.new_empty((chunk,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=group)
            return out.movedim(0, dim)
        # gloo has no reduce-scatter: the sum, then this rank's chunk
        y = xs.clone()
        dist.all_reduce(y, group=group)
        return y.narrow(dim, i * chunk, chunk).contiguous()
    return _staged(run, x, axis)


def _exchange1(x, axis: str, dim: int, sends, recvs):
    """Units of ``dim`` (its local size over ``len(sends)``, each) sent
    to the ranks of one axis: local unit i to rank ``sends[i]``, output
    unit j from rank ``recvs[j]``; a pair of ranks exchanges one unit at
    most.  One ``all_to_all_single`` with uneven splits."""
    n = axis_size(axis)
    _count("all_to_all", x, axis)
    w = x.shape[dim] // len(sends)
    src = x.movedim(dim, 0)
    order = sorted(range(len(sends)), key=lambda i: sends[i])
    inp = torch.cat([src[i * w:(i + 1) * w] for i in order])
    in_splits = [w * sends.count(r) for r in range(n)]
    out_splits = [w * recvs.count(r) for r in range(n)]
    by_src = sorted(range(len(recvs)), key=lambda j: recvs[j])

    def run(xs, group):
        out = xs.new_empty((w * len(recvs),) + tuple(xs.shape[1:]))
        dist.all_to_all_single(out, xs, out_splits, in_splits, group=group)
        return out
    got = _staged(run, inp, axis)
    units = [None] * len(recvs)
    for k, j in enumerate(by_src):
        units[j] = got[k * w:(k + 1) * w]
    return torch.cat(units).movedim(0, dim)


def _gather(x, axis, dim):
    for a in reversed(_axes(axis)):     # the minor axis first
        x = _gather1(x, a, dim)
    return x


def _scatter(x, axis, dim):
    for a in _axes(axis):               # the major axis first
        x = _scatter1(x, a, dim)
    return x


def _psum(x, axis):
    for a in _axes(axis):
        x = _reduce1(x, a)
    return x


# -- autograd Functions -------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sends, recvs):
        ctx.axis, ctx.dim, ctx.sends, ctx.recvs = axis, dim, sends, recvs
        return _exchange1(x, axis, dim, sends, recvs)

    @staticmethod
    def backward(ctx, g):
        return (_exchange1(g, ctx.axis, ctx.dim, ctx.recvs, ctx.sends),
                None, None, None, None)


@torch.compiler.disable
def _collective(fn, *args) -> torch.Tensor:
    """``fn.apply(*args)`` outside ``torch.compile``: a collective staged
    through the host is a graph break in a compiled step (its count and
    its bytes, too, are host state), and nothing it runs is traced."""
    return fn.apply(*args)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` (tiled);
    backward reduce-scatters."""
    return _collective(_AllGather, x, axis, dim) if axis_size(axis) > 1 \
        else x


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, this rank's chunk of ``dim``;
    backward all-gathers."""
    return _collective(_ReduceScatter, x, axis, dim) if axis_size(axis) > 1 \
        else x


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over ``axis``; backward is the same sum."""
    return _collective(_Psum, x, axis) if axis_size(axis) > 1 else x


def pair_halves(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """A dimension made of two halves (a fused projection's ``x | z``
    columns), sharded over ``axis`` as one contiguous dimension, as this
    rank's block of each half side by side: rank r of n holds units 2r and
    2r+1 of the 2n, and gets unit r of the first half and unit r of the
    second (one all-to-all; backward the inverse exchange)."""
    n = axis_size(axis)
    if n == 1:
        return x
    r = axis_index(axis)
    return _collective(_Exchange, x, axis, dim,
                       [(2 * r) % n, (2 * r + 1) % n],
                       [r // 2, (n + r) // 2])


@torch.compiler.disable
def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max over ``axis`` (no gradient: callers use it on
    detached values, as the shift of a log-sum-exp)."""
    x = x.detach()
    for a in _axes(axis):
        x = _reduce1(x, a, dist.ReduceOp.MAX)
    return x


def local_chunk(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of a tensor replicated over ``axis``
    (backward: the cotangent padded with zeros)."""
    n = axis_size(axis)
    if n == 1:
        return x
    chunk = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * chunk, chunk)


def reshard(x: torch.Tensor, src: Sequence[Any], dst: Sequence[Any]
            ) -> torch.Tensor:
    """A local tensor at partition spec ``src`` as its local tensor at
    ``dst`` (same global shape): each dimension whose entry changes is
    all-gathered over its ``src`` axes, then sliced over its ``dst``
    axes."""
    for d, (a, b) in enumerate(zip(src, dst)):
        if pspec_axes(a) != pspec_axes(b):
            x = all_gather(x, a, d)
    for d, (a, b) in enumerate(zip(src, dst)):
        if pspec_axes(a) != pspec_axes(b):
            for ax in _axes(b):
                x = local_chunk(x, ax, d)
    return x


def local_of(full: torch.Tensor, pspec: Sequence[Any]) -> torch.Tensor:
    """This rank's block of a global tensor at ``pspec``."""
    for d, entry in enumerate(pspec):
        for ax in _axes(entry):
            full = local_chunk(full, ax, d)
    return full
