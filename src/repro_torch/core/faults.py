"""Deterministic, site-addressable fault injection (the chaos harness).

Counterpart of ``repro.core.faults``, with the same grammar, the same
``KINDS`` and the same stable decision over ``(seed, kind, site,
attempt#)``: a seed fires the same decisions here as in the JAX package
for the same site names.  Only the environment variables differ
(``LILAC_TORCH_FAULTS``, ``LILAC_TORCH_FAULTS_SEED``), so a chaos run of
one package never injects into the other.

Fault classes (the ``kind`` namespace) and where they fire here::

    kernel_raise      Harness.__call__ raises before the body runs
    nan_output        a concrete harness output is poisoned with NaNs
    marshal_raise     a data-plane repack / conversion raises
    tune_raise        an autotune candidate measurement raises
    bake_raise        plan baking raises (falls back to the interpreter)
    cache_torn_write  a JsonStore save leaves a truncated file on disk
    shadow_diverge    a shadow comparison is forced to report divergence
    decode_raise      (serving; parsed, no site in this package yet)
    decode_nan        (serving; parsed, no site in this package yet)
    replica_crash     (serving; parsed, no site in this package yet)

Spec grammar (``LILAC_TORCH_FAULTS``): comma-separated rules, each
``kind[:site[:prob]]``.  ``site`` is an ``fnmatch`` pattern over the
injection point's name (a harness name like ``cuda.ell``, a repack name,
a cache file stem like ``autotune``, ``bake`` or ``dispatch``); omitted
or ``*`` matches every site.  ``prob`` (default 1.0) is the per-attempt
firing probability, decided by a stable hash of ``(seed, kind, site,
attempt#)``: no RNG state, so two processes with the same plan and call
sequence inject identically.

    LILAC_TORCH_FAULTS="kernel_raise:cuda.ell:0.5,nan_output:*"
    LILAC_TORCH_FAULTS_SEED=7

In a test::

    from repro_torch.core import faults
    with faults.inject("kernel_raise:cuda.ell", seed=3) as plan:
        fast(*args)
    assert plan.fired          # [(kind, site, attempt#), ...]

When no plan is active every injection point is a module-global ``None``
check.  An executable plan's program runs with injection paused
(:func:`paused`): like the JAX package's jitted plan, it is the
executable that containment does not see; faults fire where containment
observes them (the interpreter, tuning, baking, the stores).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

_ENV_SPEC = "LILAC_TORCH_FAULTS"
_ENV_SEED = "LILAC_TORCH_FAULTS_SEED"

#: every kind `parse_spec` accepts: a typo'd class is an error, not a
#: silently dead rule
KINDS = ("kernel_raise", "nan_output", "marshal_raise", "tune_raise",
         "bake_raise", "cache_torn_write", "decode_raise", "decode_nan",
         "replica_crash", "shadow_diverge")


class FaultSpecError(ValueError):
    """Malformed ``LILAC_TORCH_FAULTS`` rule (unknown kind, bad
    probability)."""


class InjectedFault(RuntimeError):
    """The exception a firing ``*_raise`` injection point raises.

    ``slot`` is meaningful only for serving decode faults."""

    def __init__(self, kind: str, site: str, slot: Optional[int] = None):
        super().__init__(f"injected fault {kind} at {site!r}"
                         + (f" (slot {slot})" if slot is not None else ""))
        self.kind = kind
        self.site = site
        self.slot = slot


@dataclasses.dataclass(frozen=True)
class FaultRule:
    kind: str
    site: str = "*"           # fnmatch pattern over injection-point names
    prob: float = 1.0


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a ``LILAC_TORCH_FAULTS`` string into rules."""
    rules: List[FaultRule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        kind = bits[0].strip()
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (valid: {', '.join(KINDS)})")
        site = bits[1].strip() if len(bits) > 1 and bits[1].strip() else "*"
        prob = 1.0
        if len(bits) > 2 and bits[2].strip():
            try:
                prob = float(bits[2])
            except ValueError:
                raise FaultSpecError(
                    f"bad probability {bits[2]!r} in rule {part!r}") from None
            if not (0.0 <= prob <= 1.0):
                raise FaultSpecError(
                    f"probability {prob} out of [0, 1] in rule {part!r}")
        rules.append(FaultRule(kind, site, prob))
    return rules


class FaultPlan:
    """An active set of rules plus the deterministic firing state.

    ``fires`` is a pure function of ``(seed, kind, site, attempt#)``; the
    per-``(kind, site)`` attempt counters are the only mutable state."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._attempts: Dict[Tuple[str, str], int] = {}
        #: chronological (kind, site, attempt#) log of every fired fault
        self.fired: List[Tuple[str, str, int]] = []

    def _rule_for(self, kind: str, site: str) -> Optional[FaultRule]:
        for r in self.rules:
            if r.kind == kind and fnmatch.fnmatchcase(site, r.site):
                return r
        return None

    def attempts(self, kind: str, site: str) -> int:
        return self._attempts.get((kind, site), 0)

    def fires(self, kind: str, site: str) -> bool:
        rule = self._rule_for(kind, site)
        if rule is None:
            return False
        key = (kind, site)
        n = self._attempts.get(key, 0)
        self._attempts[key] = n + 1
        if rule.prob >= 1.0:
            hit = True
        elif rule.prob <= 0.0:
            hit = False
        else:
            h = hashlib.blake2b(f"{self.seed}|{kind}|{site}|{n}".encode(),
                                digest_size=8).digest()
            hit = int.from_bytes(h, "big") / 2.0 ** 64 < rule.prob
        if hit:
            self.fired.append((kind, site, n))
        return hit


#: the active plan; ``None`` means every injection point is a no-op.
#: Injection sites read this module global before doing any other work.
ACTIVE: Optional[FaultPlan] = None


def load_env() -> Optional[FaultPlan]:
    """(Re-)activate from ``LILAC_TORCH_FAULTS`` /
    ``LILAC_TORCH_FAULTS_SEED``; called at import and by test isolation."""
    global ACTIVE
    spec = os.environ.get(_ENV_SPEC, "")
    if spec:
        try:
            seed = int(os.environ.get(_ENV_SEED, "0") or 0)
        except ValueError:
            seed = 0
        ACTIVE = FaultPlan(parse_spec(spec), seed=seed)
    else:
        ACTIVE = None
    return ACTIVE


@contextlib.contextmanager
def inject(spec, seed: int = 0):
    """Activate ``spec`` (a ``LILAC_TORCH_FAULTS`` string or a list of
    :class:`FaultRule`) for the block; the previous plan returns on exit."""
    global ACTIVE
    rules = parse_spec(spec) if isinstance(spec, str) else list(spec)
    prev = ACTIVE
    plan = FaultPlan(rules, seed=seed)
    ACTIVE = plan
    try:
        yield plan
    finally:
        ACTIVE = prev


@contextlib.contextmanager
def paused():
    """No injection inside the block (an executable plan's program)."""
    global ACTIVE
    prev, ACTIVE = ACTIVE, None
    try:
        yield
    finally:
        ACTIVE = prev


def check(kind: str, site: str = "*") -> bool:
    """True when an active plan fires ``kind`` at ``site`` this attempt."""
    plan = ACTIVE
    if plan is None:
        return False
    return plan.fires(kind, site)


def fail(kind: str, site: str = "*", slot: Optional[int] = None):
    """Raise :class:`InjectedFault` when the plan fires, else no-op."""
    plan = ACTIVE
    if plan is not None and plan.fires(kind, site):
        raise InjectedFault(kind, site, slot=slot)


def traced(t) -> bool:
    """A value that exists only in a trace: a fake tensor, a functional
    wrapper (``make_fx`` over ``functionalize``), any tensor subclass."""
    import torch

    return (type(t) is not torch.Tensor and type(t) is not torch.nn.Parameter) \
        or torch._is_functional_tensor(t)


def corrupt(kind: str, site: str, out):
    """Poison a concrete floating-point harness output with NaNs when the
    plan fires.  A traced value (a fake tensor or proxy under ``make_fx``)
    passes through untouched, and so does every output while the current
    stream is capturing a CUDA graph: a NaN recorded into a trace or a
    graph could never be traced back to its harness, so corruption fires
    only where containment observes it."""
    plan = ACTIVE
    if plan is None:
        return out
    import torch

    if not isinstance(out, torch.Tensor) or traced(out) \
            or not out.is_floating_point():
        return out
    if out.is_cuda and torch.cuda.is_current_stream_capturing():
        return out
    if not plan.fires(kind, site):
        return out
    return out * float("nan")


load_env()
