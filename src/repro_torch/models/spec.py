"""Parameter specification trees: shape, dtype, logical axes, and the
logical -> mesh sharding rules.

Counterpart of ``repro.models.spec``: every module describes its
parameters as a nested dict of ``ParamSpec``; from one spec tree come the
initialized parameters (``init_params``, from a seeded
``torch.Generator``), the parameter count, and each leaf's partition spec
on a mesh.

A partition spec is what it is in JAX: a tuple with one entry per tensor
dimension, None (replicated), a mesh-axis name, or a tuple of names (the
dimension split over several mesh axes, the first the major one).
``placements`` turns one into ``torch.distributed.tensor`` placements
over a ``DeviceMesh`` (``Shard(d)`` on every mesh dimension that splits
tensor dimension d, ``Replicate()`` elsewhere); a ``NamedSharding`` is a
mesh and a spec.  The rules map the logical axes to mesh axes:

  "embed"    d_model dims of weight matrices        -> FSDP axis ("data")
  "mlp"      d_ff / expert hidden dims              -> TP axis ("model")
  "heads"    attention-head dims (q)                -> TP axis ("model")
  "kv_heads" kv-head dims                           -> TP if divisible
  "vocab"    embedding/unembedding vocab dim        -> TP axis ("model")
  "expert"   MoE expert dim                         -> EP axis ("model")
  "layers"   the stacked layer dim                  -> replicated
  None       replicated

with the reference's two quirks: a mesh axis shards at most one
dimension of a leaf (the first that asks for it), and a dimension that the
axis size does not divide is replicated (kv_heads 8 on 16, 40 experts on
16).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch


#: the init kinds ``init_params`` draws (``arange_log`` and ``dt_bias``
#: are Mamba's, the reference's values)
INIT_KINDS = ("normal", "zeros", "ones", "arange_log", "dt_bias")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"     # one of INIT_KINDS
    scale: float = 1.0       # stddev multiplier for normal init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict in sorted key order (the order
    ``jax.tree.flatten`` gives a dict), paths joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_params(spec_tree, generator: torch.Generator, device=None):
    """Materialize parameters: normal leaves with std ``scale /
    sqrt(fan_in)``, drawn in f32 from ``generator`` leaf by leaf in
    :func:`leaves` order and cast.  fan_in is the leading dim of a matrix
    after a leading ``layers`` axis; the reference takes the stack's
    depth there (std 1/sqrt(2) for a 2-period model), which at full width
    drives the residual stream to ~1e5 at init.  Values from another RNG
    differ anyway: parity runs take the reference's parameters
    (``models.factory.params_from_numpy``).  An init kind outside
    ``INIT_KINDS`` raises ``ValueError`` before anything is drawn."""
    device = device or generator.device
    unknown = sorted({s.init for _, s in leaves(spec_tree)} - set(INIT_KINDS))
    if unknown:
        raise ValueError(f"unknown init kind(s) {unknown}; init_params "
                         f"draws {list(INIT_KINDS)}")

    def make(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "arange_log":
            # S4D-real: A_log[..., n] = log(n + 1), so A = -[1..N] spreads
            # the decay over the state dims
            row = np.log(np.arange(1, s.shape[-1] + 1))
            return torch.from_numpy(np.broadcast_to(row, s.shape).copy()).to(
                device=device, dtype=s.dtype)
        if s.init == "dt_bias":
            # softplus^-1(scale): softplus(dt_bias) is Mamba's timestep
            return torch.full(s.shape, float(np.log(np.expm1(s.scale))),
                              dtype=s.dtype, device=device)
        shape = s.shape[1:] if s.axes[:1] == ("layers",) else s.shape
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = s.scale / np.sqrt(max(fan_in, 1))
        return (torch.randn(s.shape, generator=generator, device=device)
                * std).to(s.dtype)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return make(tree)

    return build(spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(np.prod(s.shape) for _, s in leaves(spec_tree)))


# ---------------------------------------------------------------------------
# Sharding rules: logical axes -> mesh axes
# ---------------------------------------------------------------------------

# single pod; the multi-pod rules map "batch" to ("pod", "data") and keep
# the weight axes (the pods replicate the weights: pure DP across pods,
# FSDP within one)
SINGLE_POD_RULES: Dict[str, Any] = {
    "batch": "data",
    "embed": "data",      # FSDP / ZeRO-3 axis for weights
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "expert": "model",
    "seq": None,
    "layers": None,
}

MULTI_POD_RULES: Dict[str, Any] = {
    **SINGLE_POD_RULES,
    "batch": ("pod", "data"),
}

# compute-time rules: inside a block the weights are TP-only (replicated
# over the FSDP axis); the storage rules shard them 2-D for memory, and
# ``models.transformer._constrain`` all-gathers each layer's slice over
# "data" just in time (ZeRO-3)
COMPUTE_RULES: Dict[str, Any] = {
    **SINGLE_POD_RULES,
    "embed": None,
}

PSpec = Tuple[Any, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (in mesh order), or the
    mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_to_pspec_sizes(spec: ParamSpec, axis_sizes: Mapping[str, int],
                        rules: Mapping[str, Any]) -> PSpec:
    """Logical axes -> partition spec at the given mesh-axis sizes,
    replicating a dimension that its axes' size does not divide."""
    entries = []
    used: set = set()
    for dim, ax in zip(spec.shape, spec.axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            entries.append(None)
            continue
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            entries.append(None)
            continue
        size = int(np.prod([axis_sizes.get(a, 1) for a in axes]))
        if dim % size != 0:
            entries.append(None)
            continue
        entries.append(axes[0] if len(axes) == 1 else axes)
        used.update(axes)
    return tuple(entries)


def spec_to_pspec(spec: ParamSpec, mesh, rules: Mapping[str, Any]) -> PSpec:
    """Logical axes -> partition spec on ``mesh`` (a ``DeviceMesh`` or a
    mapping of axis sizes)."""
    return spec_to_pspec_sizes(spec, mesh_axis_sizes(mesh), rules)


def compute_pspecs(spec_tree, axis_sizes: Mapping[str, int],
                   rules: Optional[Mapping[str, Any]] = None):
    """Partition-spec tree of the compute-time (TP-only) weights."""
    rules = rules or COMPUTE_RULES
    return tree_map(lambda s: spec_to_pspec_sizes(s, axis_sizes, rules),
                    spec_tree)


def tree_pspecs(spec_tree, mesh, rules: Mapping[str, Any]):
    return tree_map(lambda s: spec_to_pspec(s, mesh, rules), spec_tree)


def pspec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition-spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(pspec: PSpec, mesh) -> list:
    """A partition spec as ``DTensor`` placements over ``mesh``'s
    dimensions: ``Shard(d)`` on each mesh dimension that splits tensor
    dimension d, ``Replicate()`` on the others.  A dimension split over
    several mesh axes (``("pod", "data")``) takes ``Shard(d)`` on each, and
    DTensor splits in mesh order, so those axes must be listed in mesh
    order: the same major-to-minor layout as JAX's."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(pspec):
        axes = pspec_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{entry!r} splits one dimension in another "
                             f"order than the mesh's {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return out


class NamedSharding(NamedTuple):
    """A mesh and a partition spec (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: PSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def tree_shardings(spec_tree, mesh, rules: Mapping[str, Any]):
    return tree_map(lambda s: NamedSharding(mesh, spec_to_pspec(s, mesh,
                                                                rules)),
                    spec_tree)


def local_shape(shape, pspec: PSpec, axis_sizes: Mapping[str, int]):
    """The per-device shape of a ``shape`` tensor at ``pspec``."""
    out = list(shape)
    for d, entry in enumerate(pspec):
        for a in pspec_axes(entry):
            out[d] //= axis_sizes.get(a, 1)
    return tuple(out)
