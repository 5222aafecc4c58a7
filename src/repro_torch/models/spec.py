"""Parameter specification trees: shape, dtype and logical axes.

Counterpart of the single-device part of ``repro.models.spec``: every
module describes its parameters as a nested dict of ``ParamSpec``; from
one spec tree come the initialized parameters (``init_params``, from a
seeded ``torch.Generator``) and the parameter count.  The logical axes are
kept for the sharding rules, which come with the distributed slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


#: the init kinds ``init_params`` draws; the reference's Mamba kinds
#: (``arange_log``, ``dt_bias``) come with the Mamba port
INIT_KINDS = ("normal", "zeros", "ones")


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
