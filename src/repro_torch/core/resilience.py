"""Contained execution and harness quarantine (the fail-safe layer).

Counterpart of ``repro.core.resilience``.  LiLAC's contract is that a
compiled program is never worse than the program it was compiled from: a
harness that raises, returns the wrong size or non-finite values is the
pass's failure, not the user's.  The pieces:

* :class:`Containment` — what every anchor of an interpreted call runs
  under (:func:`repro_torch.core.rewrite.run_rewritten`).  A failed
  attempt (an exception, an output of the wrong size, a concrete
  non-finite float output) quarantines that ``(computation, harness,
  variant)``, warns with :class:`LilacContainmentWarning`, and retries the
  anchor with the next candidate, the platform default first.  When the
  candidates run out it raises :class:`ReferenceFallback`; the pass
  manager then disables the match and the anchor runs as the plain graph
  node: the uncompiled program, the floor.  A tuner race that a candidate
  broke (:class:`~repro_torch.core.autotune.CandidateFailure`) quarantines
  that candidate and selects again.
* :class:`QuarantineStore` — the records on the
  :mod:`~repro_torch.core.jsonstore` protocol
  (``~/.cache/lilac-torch/quarantine.json``), so a harness that failed in
  one process is skipped by the next until its TTL lapses.  Its registry
  fingerprint is pinned to ``""``: a record names its harness, and an
  incident yesterday is evidence today whatever else was registered.
* :class:`AdaptiveShadowRate` — the controller of sampled shadow checks
  (a plan call also runs the uncompiled program and compares), and of the
  serving tier's request shadow (``serve.engine``: a finished request
  re-decoded alone and compared token for token; a divergence reaches
  the compiled decode's ``report_divergence``).

**What the card adds.**  On the card an exception raised by a
hand-written kernel's harness (``cuda.*``) is not contained: a kernel
that does not build or launch is a fault of the port, and running the
plain PyTorch version in its place would hide it.  It propagates to the
caller, as the tuner's :class:`~repro_torch.core.autotune.CandidateFailure`
for a race, and nothing is quarantined.  Only an injected fault
(:class:`~repro_torch.core.faults.InjectedFault`) or out of memory (the
card's state, not the kernel's) is contained there, as are wrong-size and
non-finite outputs.  A ``torch.*`` harness's exception is contained on
every platform.

Some CUDA errors poison the process's CUDA
context: 700 (illegal address), 710 (device assert), 714-718 (hardware
stack, illegal instruction, misaligned address, invalid address space,
invalid program counter) and 719 (launch failure).  After one, every
later kernel fails too, the next candidate's and the plain program's
included, so such a fault cannot be contained in-process.  Containment
writes its quarantine record to disk first and then raises
:class:`StickyDeviceFault`, which names the harness and says the process
must restart; the next process skips the harness, with a warning, until
the TTL.  Out of memory (2), invalid value (1), out of resources (701) and
invalid configuration (9) leave the context usable: raised by a
``torch.*`` harness they are contained like any exception, and raised by a
``cuda.*`` kernel only out of memory is.  An asynchronous fault surfaces at the next sync, which may be
the validator's own ``isfinite``: the validator never swallows a fault of
the card.

The validator syncs (``bool(torch.isfinite(out).all())`` waits for the
device), so it runs only on the interpreter path: a first call, a
``bake=False`` call, a call a plan could not serve.  It never reads a
traced value (a fake or functional output under ``make_fx`` or a
``torch.compile`` trace is checked for size only, and the pass manager
counts it in ``resilience_info()["unread_traced"]``), and it reads a
concrete one outside the ambient dispatch modes, as ``detect.own_trace``
detects, so a call under a real-mode ``make_fx`` records no check in the
caller's graph.  It never runs during a CUDA-graph capture, or on a baked
plan's call, eager or replayed; the sampled shadow checks watch that
path.  A host-mode
scan validates its first step's outputs; its later steps run the same
harnesses under :class:`SteadySteps`, which keeps each output's largest
magnitude on the device and syncs once after the loop.

Environment knobs: ``LILAC_TORCH_QUARANTINE_CACHE`` (store path),
``LILAC_TORCH_QUARANTINE_TTL`` (seconds, default 3600; ``<= 0`` never
expires), ``LILAC_TORCH_SHADOW_RATE`` (in [0, 1]: the floor fraction of
plan calls shadowed), ``LILAC_TORCH_REQUEST_SHADOW_RATE`` (the floor
fraction of a serving engine's finished requests re-decoded solo),
``LILAC_TORCH_SHADOW_SPIKE`` / ``LILAC_TORCH_SHADOW_DECAY`` (the adaptive
controller, both rates).
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core import faults, levels
from repro_torch.core.jsonstore import JsonStore, cache_dir

_ENV_PATH = "LILAC_TORCH_QUARANTINE_CACHE"
_ENV_TTL = "LILAC_TORCH_QUARANTINE_TTL"
_ENV_SPIKE = "LILAC_TORCH_SHADOW_SPIKE"
_ENV_DECAY = "LILAC_TORCH_SHADOW_DECAY"
ENV_SHADOW = "LILAC_TORCH_SHADOW_RATE"
#: the serving tier's request-level shadow rate (``serve.engine``)
ENV_REQUEST_SHADOW = "LILAC_TORCH_REQUEST_SHADOW_RATE"
DEFAULT_TTL_S = 3600.0
DEFAULT_SHADOW_SPIKE = 16.0
DEFAULT_SHADOW_DECAY = 0.5
#: shadow tolerance of a bf16 / f16 output: relative L2 error against the
#: uncompiled program (the MoE block's, PERF.md section 2)
HALF_REL_L2 = 2e-2


def default_quarantine_path() -> Path:
    env = os.environ.get(_ENV_PATH)
    return Path(env) if env else cache_dir() / "quarantine.json"


def default_ttl_s() -> float:
    try:
        return float(os.environ.get(_ENV_TTL, DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


class LilacContainmentWarning(UserWarning):
    """A harness failed and was contained: its output was not used, it is
    quarantined, and the call ran another candidate or the plain
    program.  Also raised each time a selection skips a quarantined
    harness (:func:`warn_skip`)."""


class StickyDeviceFault(RuntimeError):
    """A harness hit a CUDA error that poisons the process's CUDA context;
    its quarantine record is on disk, and the process must restart."""

    def __init__(self, computation: str, harness: str, variant: str,
                 code: int, cause: BaseException):
        super().__init__(
            f"{computation}: harness {harness!r} (variant {variant}) hit "
            f"CUDA error {code}, which leaves this process's CUDA context "
            f"unusable; it is quarantined on disk, restart the process "
            f"({type(cause).__name__}: {cause})")
        self.computation = computation
        self.harness = harness
        self.variant = variant
        self.code = code


#: CUDA errors after which the context is unusable, by the runtime's
#: message (cudaGetErrorString)
STICKY_CODES = {
    700: "an illegal memory access was encountered",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
}
_CODE_RE = re.compile(r"cudaError[ _:=]*(\d+)")


def _chain(e: BaseException):
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        yield e
        e = e.__cause__ or e.__context__


def sticky_error_code(e: BaseException) -> Optional[int]:
    """The CUDA error code of ``e`` (or of an error it was raised from)
    when it is one that poisons the context, else None: a
    ``torch.AcceleratorError``'s code, the ``cudaError N`` of a kernel
    wrapper's launch check, or the runtime's message."""
    for x in _chain(e):
        code = getattr(x, "error_code", None)
        if isinstance(code, int) and code in STICKY_CODES:
            return code
        text = str(x)
        for m in _CODE_RE.finditer(text):
            if int(m.group(1)) in STICKY_CODES:
                return int(m.group(1))
        for code, msg in STICKY_CODES.items():
            if msg in text:
                return code
    return None


def injected_or_oom(e: BaseException) -> bool:
    """``e`` is (or was raised from) an injected fault or out of memory:
    the only failures on the card that say nothing of the port's code."""
    return any(isinstance(x, (faults.InjectedFault,
                              torch.cuda.OutOfMemoryError))
               for x in _chain(e))


def kernel_fault(harness: str, platform: str, e: BaseException) -> bool:
    """``e`` is a failure of a hand-written kernel on the card, which
    containment lets through: a ``cuda.*`` harness raised something that
    is neither an injected fault nor out of memory."""
    return (platform == "cuda" and harness.startswith("cuda.")
            and not injected_or_oom(e))


def device_fault(e: BaseException) -> bool:
    """A failure of the card itself (out of memory, a CUDA runtime error),
    which says nothing of the computation that was running."""
    accel = getattr(torch, "AcceleratorError", None)
    for x in _chain(e):
        if isinstance(x, torch.cuda.OutOfMemoryError) \
                or (accel is not None and isinstance(x, accel)) \
                or "CUDA error" in str(x) \
                or _CODE_RE.search(str(x)) is not None:
            return True
    return False


@dataclasses.dataclass
class QuarantineStats:
    added: int = 0
    hits: int = 0            # lookups answered "yes, quarantined"
    expired: int = 0         # records lazily purged on lookup
    invalidations: int = 0
    save_errors: int = 0
    corrupt_recoveries: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class QuarantineStore(JsonStore):
    """Persistent ``(computation, harness, variant) -> incident`` records::

        {"schema": 1, "registry": "",
         "entries": {"spmv_csr|cuda.ell|default": {
             "reason": "exception: ...", "site": "cuda.ell",
             "t": 1754640000.0, "ttl": 3600.0}}}

    ``variant`` is :func:`repro_torch.core.autotune.variant_key` of the
    (schedule, fuse) the harness ran with: a bad schedule quarantines that
    schedule, not the harness; the ``"default"`` variant is what selection
    and containment's fallback consult."""

    schema_version = 1

    def __init__(self, path: Optional[os.PathLike] = None):
        self.stats = QuarantineStats()   # before super(): _note_* hooks
        super().__init__(path, registry_fingerprint="")

    def default_path(self) -> Path:
        return default_quarantine_path()

    def _note_invalidation(self):
        self.stats.invalidations += 1

    def _note_save_error(self):
        self.stats.save_errors += 1

    def _note_corrupt_recovery(self):
        self.stats.corrupt_recoveries += 1

    @staticmethod
    def key_of(comp: str, harness: str, vkey: str = "default") -> str:
        return f"{comp}|{harness}|{vkey}"

    def _ensure_loaded(self):
        if not self.loaded:
            self.load()

    @staticmethod
    def _expired(rec: Dict[str, Any], now: Optional[float] = None) -> bool:
        ttl = float(rec.get("ttl", DEFAULT_TTL_S))
        if ttl <= 0:
            return False
        t = float(rec.get("t", 0.0))
        return (time.time() if now is None else now) - t > ttl

    def add(self, comp: str, harness: str, vkey: str = "default", *,
            reason: str, site: str = "", ttl: Optional[float] = None,
            persist: bool = True) -> str:
        self._ensure_loaded()
        key = self.key_of(comp, harness, vkey)
        self.entries[key] = {
            "reason": str(reason)[:500],
            "site": site,
            "t": time.time(),
            "ttl": float(ttl if ttl is not None else default_ttl_s()),
        }
        self.stats.added += 1
        if persist:
            self.save()
        return key

    def is_quarantined(self, comp: str, harness: str,
                       vkey: str = "default") -> bool:
        self._ensure_loaded()
        key = self.key_of(comp, harness, vkey)
        rec = self.entries.get(key)
        if rec is None:
            return False
        if self._expired(rec):
            del self.entries[key]
            self.stats.expired += 1
            return False
        self.stats.hits += 1
        return True

    def active(self) -> Dict[str, Dict[str, Any]]:
        """All unexpired records (purging expired ones)."""
        self._ensure_loaded()
        now = time.time()
        for k in [k for k, r in self.entries.items()
                  if self._expired(r, now)]:
            del self.entries[k]
            self.stats.expired += 1
        return dict(self.entries)

    def clear(self) -> None:
        """Drop every record, on disk too."""
        self.entries = {}
        self.loaded = True
        try:
            os.unlink(self.path)
        except OSError:
            pass


_SHARED: Dict[str, QuarantineStore] = {}


def shared_quarantine(path: Optional[os.PathLike] = None) -> QuarantineStore:
    """The process-wide store of a file: every compiled function and the
    tuner consult one in-memory view, so an incident one function saw
    protects the others at once."""
    key = str(Path(path) if path is not None else default_quarantine_path())
    q = _SHARED.get(key)
    if q is None:
        q = _SHARED[key] = QuarantineStore(key)
    return q


def reset_shared_quarantine():
    """Drop the process-wide views (tests; a store file rewritten from
    outside is otherwise invisible to functions compiled afterwards)."""
    _SHARED.clear()


def quarantined(q: QuarantineStore, comp: str, harness: str,
                vkey: str = "default") -> bool:
    """The harness is quarantined at ``vkey`` or as a whole (its default
    variant)."""
    return q.is_quarantined(comp, harness, vkey) \
        or (vkey != "default" and q.is_quarantined(comp, harness))


# ---------------------------------------------------------------------------
# Contained anchor execution
# ---------------------------------------------------------------------------

class ReferenceFallback(Exception):
    """Every candidate for an anchor failed; the pass manager disables the
    match so the anchor runs as the plain graph node."""

    def __init__(self, match, reason: str):
        super().__init__(
            f"all harness candidates failed for {match.computation} "
            f"({reason}); falling back to the uncompiled program")
        self.match = match
        self.reason = reason


@dataclasses.dataclass
class ContainmentStats:
    contained_exceptions: int = 0
    nonfinite_outputs: int = 0
    shape_mismatches: int = 0
    quarantines: int = 0
    fallbacks: int = 0       # anchors that exhausted every candidate
    shadow_checks: int = 0
    shadow_divergences: int = 0
    shadow_errors: int = 0   # shadows whose uncompiled run raised: unchecked
    sticky_faults: int = 0   # CUDA errors recorded and raised, not contained
    quarantine_skips: int = 0  # selections that passed over a quarantine

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class Containment:
    """The per-anchor retry loop that ``run_rewritten`` calls instead of
    selecting and invoking a harness itself.

    ``select(m, binding, ctx)`` picks the first candidate (the tuner may
    run); ``attempt(h, ctx)`` runs one candidate's full call (fusion,
    epilogue, the result in the anchor's dtype and shape).  A raised
    exception, an output whose size differs from the anchor's, or a
    concrete non-finite float output is a failure: the exact
    ``(computation, harness, variant)`` is quarantined and the next
    candidate runs.  A success returns the output unchanged.  On the card
    a ``cuda.*`` harness's own exception (:func:`kernel_fault`) is not a
    failure to contain: it propagates, and nothing is quarantined.
    ``read_batched=False`` leaves a batched output unread (the steady
    calls of a vmapped entry, which the shadow check samples instead);
    ``on_unread()`` is called for each traced output, whose values no
    check can read (a graph's own trace, or a call traced into a user's
    graph)."""

    def __init__(self, registry, quarantine: QuarantineStore,
                 on_quarantine: Optional[Callable[..., None]] = None,
                 stats: Optional[ContainmentStats] = None,
                 read_batched: bool = True,
                 on_unread: Optional[Callable[[], None]] = None):
        self.registry = registry
        self.quarantine = quarantine
        self.on_quarantine = on_quarantine
        self.stats = stats if stats is not None else ContainmentStats()
        self.read_batched = read_batched
        self.on_unread = on_unread

    def pick(self, m, binding, ctx, select):
        """``select(m, binding, ctx)``, contained: a tuner race that one
        candidate broke quarantines that candidate and races again (a
        ``cuda.*`` candidate on the card raises through)."""
        from repro_torch.core.autotune import CandidateFailure, variant_key

        raced = set()
        while True:
            try:
                return select(m, binding, ctx)
            except CandidateFailure as e:
                vkey = variant_key(e.schedule, e.fuse)
                if (e.harness, vkey) in raced:
                    self.stats.fallbacks += 1
                    raise ReferenceFallback(m, _reason(e)) from e
                raced.add((e.harness, vkey))
                self._sticky(m, e.harness, vkey, ctx, e)
                if kernel_fault(e.harness, ctx.platform, e):
                    raise
                self.stats.contained_exceptions += 1
                self._record(m, e.harness, vkey, _reason(e))

    def __call__(self, m, binding, ctx, select, attempt, on_select=None):
        from repro_torch.core.autotune import variant_key
        from repro_torch.core.detect import out_like

        like = out_like(m)
        tried = set()
        h, c = self.pick(m, binding, ctx, select), ctx
        while True:
            if on_select is not None:
                on_select(m, h, c)
            tried.add(h.name)
            vkey = variant_key(c.schedule, c.fuse)
            try:
                out = attempt(h, c)
                reason = self._validate(out, like)
            except Exception as e:  # the boundary: degrade, never die
                self._sticky(m, h.name, vkey, c, e)
                if kernel_fault(h.name, c.platform, e):
                    raise       # a kernel of the port is broken: say so
                self.stats.contained_exceptions += 1
                reason = _reason(e)
            if reason is None:
                return out
            self._record(m, h.name, vkey, reason)
            nxt = self._next_candidate(m, c, tried)
            if nxt is None:
                self.stats.fallbacks += 1
                raise ReferenceFallback(m, reason)
            h, c = nxt

    def _validate(self, out, like) -> Optional[str]:
        if not isinstance(out, torch.Tensor):
            return f"non-tensor output: {type(out).__name__}"
        if out.numel() != like.numel():
            self.stats.shape_mismatches += 1
            return (f"shape mismatch: got {tuple(out.shape)}, the anchor "
                    f"wants {tuple(like.shape)}")
        if faults.traced(levels.base(out)):
            if self.on_unread is not None:
                self.on_unread()
            return None
        if not _readable(out) \
                or (not self.read_batched and levels.batched(out)):
            return None
        # under vmap the bool is batched: read it below the levels
        return self._finite(
            lambda: levels.base(torch.isfinite(out).all()).all())

    def _finite(self, flag: Callable[[], Any]) -> Optional[str]:
        """Read the device bool ``flag()`` (a sync): None when it holds.
        It is computed outside any ambient dispatch mode, so that a
        concrete call under a real-mode ``make_fx`` records no check in the
        caller's graph."""
        try:
            with _outside_modes():
                finite = bool(flag())
        except Exception as e:
            if device_fault(e):
                raise           # the card's fault, surfacing at this sync
            return None         # the validator never fails a healthy call
        if not finite:
            self.stats.nonfinite_outputs += 1
            return "non-finite output"
        return None

    def give_up(self, m, harness: str, vkey: str, reason: str):
        """Quarantine ``harness`` and fall back for ``m`` with no next
        candidate."""
        self._record(m, harness, vkey, reason)
        self.stats.fallbacks += 1
        raise ReferenceFallback(m, reason)

    def _sticky(self, m, harness: str, vkey: str, ctx, e: BaseException):
        """Record-then-raise for an error that poisons the CUDA context."""
        if ctx.platform != "cuda":
            return
        code = sticky_error_code(e)
        if code is None:
            return
        self.stats.sticky_faults += 1
        self.quarantine.add(m.computation, harness, vkey,
                            reason=f"sticky CUDA error {code}: {_reason(e)}",
                            site=harness, persist=True)
        raise StickyDeviceFault(m.computation, harness, vkey, code, e) from e

    def _record(self, m, harness: str, vkey: str, reason: str):
        self.stats.quarantines += 1
        self.quarantine.add(m.computation, harness, vkey, reason=reason,
                            site=harness)
        warnings.warn(LilacContainmentWarning(
            f"{m.computation}: harness {harness!r} (variant {vkey}) failed "
            f"and is quarantined: {reason}"), stacklevel=4)
        if self.on_quarantine is not None:
            self.on_quarantine(m, harness, vkey, reason)

    def _next_candidate(self, m, ctx, tried) -> Optional[Tuple[Any, Any]]:
        """The next harness for this anchor, at the default variant: a
        schedule that just failed is no basis for trusting another tuned
        one."""
        h = next_candidate(self.registry, self.quarantine, m, ctx.platform,
                           ctx.mode, tried)
        if h is None:
            return None
        return h, dataclasses.replace(ctx, schedule=None, fuse=None)


def _outside_modes():
    """The ambient dispatch modes (``make_fx``'s proxy mode, a fake or
    functional mode) set aside; the ``torch.func`` levels stay, so a
    batched output is read below them as before."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def _readable(out) -> bool:
    """Whether the validator reads ``out``'s values: a concrete float
    tensor (batched or not), outside a CUDA-graph capture."""
    return (out.is_floating_point() or out.is_complex()) \
        and not faults.traced(levels.base(out)) \
        and not (out.is_cuda and torch.cuda.is_current_stream_capturing())


class SteadySteps:
    """Containment for the steps of a host-mode scan after its first
    (``rewrite._eval_scan_body``), whose ``select`` returns the harness
    the first step settled on.  An output is not validated step by step:
    its largest magnitude (one device reduction, which a NaN propagates
    through) is kept on the device, and all of them are read once, after
    the loop (:meth:`settle`).  A failure has no next candidate: the
    harness is quarantined and its match falls back, so the scan runs
    again as the plain graph node, whole; no replacement joins in the
    middle of the loop."""

    def __init__(self, contain: Containment):
        self.contain = contain
        # anchor -> (match, harness, variant, [largest magnitude a step])
        self.peaks: Dict[Any, tuple] = {}

    def __call__(self, m, binding, ctx, select, attempt, on_select=None):
        from repro_torch.core.autotune import variant_key

        c = self.contain
        h = select(m, binding, ctx)
        vkey = variant_key(ctx.schedule, ctx.fuse)
        try:
            out = attempt(h, ctx)
            peak = None
            if _readable(out) and out.numel():
                with _outside_modes():
                    peak = torch.linalg.vector_norm(out, float("inf"))
        except Exception as e:  # the boundary: degrade, never die
            c._sticky(m, h.name, vkey, ctx, e)
            if kernel_fault(h.name, ctx.platform, e):
                raise
            c.stats.contained_exceptions += 1
            c.give_up(m, h.name, vkey, _reason(e))
        if peak is not None:
            self.peaks.setdefault(m.anchor, (m, h.name, vkey, []))[3] \
                .append(peak)
        return out

    def settle(self) -> None:
        """After the loop: a match one of whose outputs was not finite
        falls back (one sync a match)."""
        for m, name, vkey, peaks in self.peaks.values():
            reason = self.contain._finite(
                lambda p=peaks: torch.isfinite(torch.stack(p)).all())
            if reason is not None:
                self.contain.give_up(m, name, vkey, reason)


def next_candidate(registry, quarantine: QuarantineStore, m, platform: str,
                   mode: str, skip) -> Optional[Any]:
    """The first harness for match ``m`` that is not in ``skip`` and not
    quarantined: the platform default first (the best-vetted body), then
    registration order."""
    cands = registry.candidates(m.computation, m.format, platform, mode)
    dname = registry.default_name(m.computation, platform)
    for h in sorted(cands, key=lambda h: h.name != dname):
        if h.name not in skip \
                and not quarantine.is_quarantined(m.computation, h.name):
            return h
    return None


def warn_skip(comp: str, harness: str, vkey: str, instead: str) -> None:
    """The loud side of a quarantine skip: a selection passed over a
    quarantined harness (a record of this process or an earlier one);
    ``instead`` says what runs in its place."""
    warnings.warn(LilacContainmentWarning(
        f"{comp}: harness {harness!r} (variant {vkey}) is quarantined and "
        f"skipped until the record expires or the store is cleared; "
        f"{instead}"), stacklevel=3)


def _reason(e: BaseException) -> str:
    return f"exception: {type(e).__name__}: {e}"[:300]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def outputs_close(got, want, rtol: float = 1e-4, atol: float = 1e-5) -> bool:
    """Leafwise comparison for shadow verification: every pair of leaves
    must match in total size and, for floats, be close; a NaN in the
    accelerated output where the reference has none is a divergence.

    A float32/float64 leaf is held to ``allclose(rtol, atol)`` (the JAX
    package's numbers).  A bf16 or f16 leaf is held to a relative L2 error
    of at most ``HALF_REL_L2``: its kernels sum in another order than the
    uncompiled program, and elementwise half-precision rounding would
    report false divergences.

    Under ``torch.func.vmap`` the leaves are batched and each element is
    held to its own bound: the verdict is a batched bool, read from the
    tensor below the levels (``levels.base``)."""
    g_leaves, w_leaves = tree_leaves(got), tree_leaves(want)
    if len(g_leaves) != len(w_leaves):
        return False
    for g, w in zip(g_leaves, w_leaves):
        ga, wa = _as_tensor(g), _as_tensor(w)
        if ga.numel() != wa.numel():
            return False
        ga = ga.reshape(wa.shape).to(wa.device)
        if wa.is_floating_point() or wa.is_complex():
            ok = torch.isnan(wa).any() | ~torch.isnan(ga).any()
            if wa.dtype in (torch.bfloat16, torch.float16):
                gf, wf = ga.float(), wa.float()
                both = torch.isnan(gf) & torch.isnan(wf)
                gf, wf = gf.masked_fill(both, 0), wf.masked_fill(both, 0)
                den = torch.linalg.vector_norm(wf)
                err = torch.linalg.vector_norm(gf - wf)
                ok = ok & (err <= HALF_REL_L2 * den)
            else:
                ok = ok & _isclose(ga.to(wa.dtype), wa, rtol, atol).all()
        else:
            ok = (ga.to(wa.dtype) == wa).all()
        if not bool(levels.base(ok).all()):
            return False
    return True


def _isclose(a, b, rtol: float, atol: float) -> torch.Tensor:
    """``torch.isclose(a, b, rtol, atol, equal_nan=True)`` from ops that
    batch under ``vmap`` (``aten::isclose`` has no batching rule)."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b)) \
        | ((a - b).abs() <= atol + rtol * b.abs())


# ---------------------------------------------------------------------------
# Adaptive shadow rate
# ---------------------------------------------------------------------------

def shadow_spike() -> float:
    """``LILAC_TORCH_SHADOW_SPIKE``: incident multiplier (default 16,
    min 1)."""
    try:
        return max(1.0, float(os.environ.get(_ENV_SPIKE,
                                             DEFAULT_SHADOW_SPIKE)))
    except ValueError:
        return DEFAULT_SHADOW_SPIKE


def shadow_decay() -> float:
    """``LILAC_TORCH_SHADOW_DECAY``: per-clean-check decay of the
    multiplier (default 0.5, clamped into (0, 1))."""
    try:
        d = float(os.environ.get(_ENV_DECAY, DEFAULT_SHADOW_DECAY))
    except ValueError:
        return DEFAULT_SHADOW_DECAY
    return min(max(d, 1e-6), 0.999999)


class AdaptiveShadowRate:
    """Incident-driven controller of sampled shadow verification.

    The environment's rate (``env_var``, or the ``floor`` override) is a
    floor: ``effective() = min(1, floor * multiplier)``.  An incident
    (:meth:`spike`: a shadow divergence or a quarantine) raises the
    multiplier to ``LILAC_TORCH_SHADOW_SPIKE``; each clean shadow check
    (:meth:`clean`) decays it by ``LILAC_TORCH_SHADOW_DECAY`` back to 1.
    The floor is re-read per call through an identity check on the cached
    environment string, one dict lookup on the hot path.

    A shadow check runs the uncompiled program on the card beside the
    plan: at the sizes ``chip_smoke.py`` runs, the naive CSR SpMV at NPB-C
    and the naive bf16 MoE block (PERF.md lists the measured times), so a
    rate of 1 roughly doubles a call or worse."""

    def __init__(self, env_var: str = ENV_SHADOW,
                 floor: Optional[float] = None):
        self.env_var = env_var
        self._floor_override = floor
        self._raw: Any = object()      # sentinel != any env string
        self._floor_cached = 0.0
        self.multiplier = 1.0
        self.peak_multiplier = 1.0
        self.incidents = 0
        self.clean_streak = 0
        self.checks = 0

    def floor(self) -> float:
        if self._floor_override is not None:
            return min(max(float(self._floor_override), 0.0), 1.0)
        raw = os.environ.get(self.env_var)
        if raw is not self._raw:
            self._raw = raw
            try:
                self._floor_cached = min(max(float(raw or 0.0), 0.0), 1.0)
            except ValueError:
                self._floor_cached = 0.0
        return self._floor_cached

    def effective(self) -> float:
        return min(1.0, self.floor() * self.multiplier)

    def spike(self, reason: str = ""):
        self.incidents += 1
        self.clean_streak = 0
        self.multiplier = max(self.multiplier, shadow_spike())
        self.peak_multiplier = max(self.peak_multiplier, self.multiplier)

    def clean(self):
        self.checks += 1
        self.clean_streak += 1
        if self.multiplier > 1.0:
            self.multiplier = max(1.0, self.multiplier * shadow_decay())

    def snapshot(self) -> Dict[str, Any]:
        return {
            "floor": self.floor(),
            "multiplier": self.multiplier,
            "peak_multiplier": self.peak_multiplier,
            "effective": self.effective(),
            "incidents": self.incidents,
            "clean_streak": self.clean_streak,
            "checks": self.checks,
            "spike": shadow_spike(),
            "decay": shadow_decay(),
        }
