"""Persistent, signature-keyed backend autotuning (paper §3.3 / Table 2).

Counterpart of ``repro.core.autotune``.  No sparse backend wins
everywhere: the right harness depends on platform, format and input
structure.  SparseX answers this by tuning once per matrix and reusing the
decision; LiLAC inherits the idea at the harness-selection boundary.

* ``signature_of`` buckets a harness call's binding into a stable key
  ``(computation, format, platform, shape buckets, sparsity bucket,
  floating dtypes)``:
  shapes to powers of two, density to decades, so that "the same kind of
  problem" reuses one decision across calls, processes and slightly
  different inputs.  It reads shapes only, so a fake tensor of a traced
  graph gives the key its real tensor gives.
* ``AutotuneCache`` is the versioned JSON file
  (``~/.cache/lilac-torch/autotune.json``), on the
  :mod:`~repro_torch.core.jsonstore` protocol, at schema 4.  This package
  never wrote an earlier schema: a file of another schema is dropped.
* ``Autotuner.select`` measures the candidates on a cache miss, pins the
  winner and persists it.  Host mode times steady-state eager calls
  through the data plane; trace mode times each jit-safe candidate on
  operands synthesized from the traced shapes.  Under budget, or when
  nothing can be measured, it falls back to the platform default.

The winner minimizes the **repack-amortized** cost: a candidate's best
steady-state time plus its measured conversion-path seconds spread over
``MarshalPolicy.reuse`` calls, so a backend with a fast kernel but a
ruinous repack wins only where the repack amortizes.  The search sweeps
**schedules** (each candidate's constraint-filtered ``tune`` variants)
and, at a call site with a detected epilogue, the **fused and unfused**
realizations of a ``fuse epilogue`` harness, by successive halving: cheap
single-repetition rounds shrink the pool to the budget, then the
survivors are timed properly.  A record keeps every survivor as a
``(schedule, fuse, seconds)`` triple under ``variants``, the table a joint
plan search will re-cost without re-timing.

A candidate that cannot run here (a repack or a kernel that runs out of
the card's memory, operands or a variant its harness refuses with a
``ValueError``, an injected ``tune_raise``) is eliminated; on the card the
allocator's cache is emptied after it, and the data-plane entries it built
are dropped.  Any other error (a kernel that does not build or launch)
must not quietly lose the race: it propagates as a
:class:`CandidateFailure` that names the candidate; the broken race
stores nothing.  The containment boundary
(:mod:`repro_torch.core.resilience`) lets it reach the caller when the
candidate is a ``cuda.*`` kernel on the card, and otherwise quarantines
that candidate and selects again.  A quarantined candidate or variant is
left out of every race (``quarantine_skips``; a skipped harness warns),
and a stored winner that has since been quarantined is re-tuned.  The
data plane keeps a candidate's entries only while it is the cheapest so
far, so a losing repack never holds the memory a later candidate needs;
after a measurement it holds the winner's alone.

Timing: on the card with CUDA events around each call on the current
stream, on the CPU with ``perf_counter``.  The first call of a candidate
(its kernel's build, its repack) is a warm-up that is not timed.

Environment knobs:

  LILAC_TORCH_AUTOTUNE_CACHE         cache file path
                                     (default ~/.cache/lilac-torch/
                                     autotune.json)
  LILAC_TORCH_AUTOTUNE_BUDGET        most candidates given steady-state
                                     timing per signature (default 8)
  LILAC_TORCH_AUTOTUNE_MAX_VARIANTS  cap on the swept variant pool per
                                     signature (default 64; defaults
                                     survive the cap)
  LILAC_TORCH_AUTOTUNE_DISABLE       "1": never measure or persist;
                                     defaults only
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import faults, levels
from repro_torch.core import resilience as R
from repro_torch.core.jsonstore import JsonStore, cache_dir

SCHEMA_VERSION = 4
_ENV_PATH = "LILAC_TORCH_AUTOTUNE_CACHE"
_ENV_BUDGET = "LILAC_TORCH_AUTOTUNE_BUDGET"
_ENV_MAX_VARIANTS = "LILAC_TORCH_AUTOTUNE_MAX_VARIANTS"
_ENV_DISABLE = "LILAC_TORCH_AUTOTUNE_DISABLE"
_DEFAULT_BUDGET = 8
_DEFAULT_MAX_VARIANTS = 64


def default_cache_path() -> Path:
    env = os.environ.get(_ENV_PATH)
    return Path(env) if env else cache_dir() / "autotune.json"


def autotune_disabled() -> bool:
    return os.environ.get(_ENV_DISABLE, "") == "1"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def exploration_budget() -> int:
    return _env_int(_ENV_BUDGET, _DEFAULT_BUDGET)


def variant_cap() -> int:
    """Cap on the swept (harness, schedule, fuse) pool per signature."""
    return _env_int(_ENV_MAX_VARIANTS, _DEFAULT_MAX_VARIANTS)


def schedule_key(schedule: Optional[Dict[str, Any]]) -> str:
    """Canonical string of a schedule variant ('default' for None/{})."""
    if not schedule:
        return "default"
    return ",".join(f"{k}={schedule[k]}" for k in sorted(schedule))


def variant_key(schedule: Optional[Dict[str, Any]],
                fuse: Optional[bool] = None) -> str:
    """Record key of a (schedule, fuse) variant; ``fuse=None`` (no epilogue
    at the site, or a harness that cannot fuse) adds nothing."""
    k = schedule_key(schedule)
    if fuse is True:
        return k + "|fused"
    if fuse is False:
        return k + "|unfused"
    return k


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

def pow2_bucket(n: int) -> int:
    """Round a positive extent up to the next power of two (0 stays 0)."""
    n = int(n)
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


def sparsity_bucket(frac: float) -> str:
    """Decade bucket of a density fraction: 1e-4 -> 'd-4'; unknown -> 'd?'."""
    if not (frac > 0.0):
        return "d?"
    return f"d{int(math.floor(math.log10(min(frac, 1.0))))}"


def _shape_of(v: Any) -> Optional[Tuple[int, ...]]:
    shape = getattr(v, "shape", None)
    return None if shape is None else tuple(int(s) for s in shape)


def signature_of(comp: str, fmt: str, platform: str,
                 binding: Dict[str, Any],
                 epilogue: Optional[str] = None) -> str:
    """Stable string key of one harness call site.  It reads shapes,
    dtypes and Python scalars only, never data, so real and fake tensors
    give one key.  ``epilogue`` tunes fused-epilogue sites apart from plain
    ones.  The reference's key is this one without its last part, the
    dtypes of the floating operands (``|dt:a=float32,...``): a kernel's
    body can differ by dtype (K4's bf16 body runs on the tensor cores, its
    f32 body does not), so one shape in two dtypes tunes apart."""
    dims: List[str] = []
    dtypes: List[str] = []
    rows = nnz = cols = None
    for k in sorted(binding):
        v = binding[k]
        if isinstance(v, bool):
            dims.append(f"{k}={v}")
        elif isinstance(v, int):
            dims.append(f"{k}={pow2_bucket(v)}")
            if k == "rows":
                rows = v
            elif k == "nnz":
                nnz = v
        elif isinstance(v, float):
            continue
        else:
            shape = _shape_of(v)
            if shape is not None:
                dims.append(f"{k}={'x'.join(str(pow2_bucket(s)) for s in shape)}")
                dt = getattr(v, "dtype", None)
                if (dt.is_floating_point if isinstance(dt, torch.dtype)
                        else getattr(dt, "kind", "") == "f"):
                    dtypes.append(f"{k}={str(dt).replace('torch.', '')}")
                if k in ("iv", "vector", "vec", "dense") and shape:
                    cols = shape[0]
    if rows and nnz and cols:
        sb = sparsity_bucket(nnz / float(rows * cols))
    else:
        sb = "d?"
    sig = "|".join([comp, fmt, platform, ",".join(dims), sb])
    if epilogue:
        sig += f"|ep:{epilogue}"
    if dtypes:
        sig += "|dt:" + ",".join(dtypes)
    return sig


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuneStats:
    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    timing_calls: int = 0      # steady-state candidate measurements
    stores: int = 0
    fallbacks: int = 0         # budget or measurability forced a default
    invalidations: int = 0     # whole files dropped (schema/fingerprint)
    remeasures: int = 0        # stale records re-tuned
    elimination_calls: int = 0  # single-repetition sweep measurements
    eliminated: int = 0        # variants that raised
    save_errors: int = 0       # persistence failed (unwritable path)
    corrupt_recoveries: int = 0  # torn cache file moved aside
    quarantine_skips: int = 0  # candidates/variants left out by quarantine

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def reset(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class AutotuneCache(JsonStore):
    """The JSON store of tuning decisions, nested per signature then mode.

    Layout (schema 4)::

        {"schema": 4, "registry": "<fingerprint>",
         "entries": {"<sig>": {"<mode>": {
             "harness": ..., "best_s": ..., "timings": {...},
             "marshal_s": {...}, "reuse": 100.0, "amortized_s": {...},
             "schedule": {...} | null, "schedules": {...},
             "fuse": true | false | null, "fuses": {...},
             "variant_s": {...}, "variants": {...}}}}}

    ``timings`` are each harness's best steady-state seconds; ``marshal_s``
    its measured conversion-path seconds; ``amortized_s`` their combination
    at ``reuse`` calls a matrix, which the winner minimizes.  ``schedule``
    and ``fuse`` are the winner's variant, ``schedules``/``fuses`` each
    harness's best; ``variant_s`` maps ``{harness: {variant_key: s}}`` and
    ``variants`` holds the same survivors as ``{harness: [[schedule,
    fuse, seconds], ...]}``.
    """

    schema_version = SCHEMA_VERSION

    def __init__(self, path: Optional[os.PathLike] = None,
                 registry_fingerprint: str = ""):
        self.stats = TuneStats()   # before super(): the hooks need it
        super().__init__(path, registry_fingerprint)

    def default_path(self) -> Path:
        return default_cache_path()

    def _note_invalidation(self):
        self.stats.invalidations += 1

    def _note_save_error(self):
        self.stats.save_errors += 1

    def _note_corrupt_recovery(self):
        self.stats.corrupt_recoveries += 1

    def _merge(self, base, incoming, overwrite):
        """Merge at the mode level, so tuners working on different modes of
        one signature do not clobber each other."""
        for sig, modes in incoming.items():
            if not isinstance(modes, dict):
                continue
            slot = base.setdefault(sig, {})
            for m, rec in modes.items():
                if overwrite or m not in slot:
                    slot[m] = rec

    def get(self, sig: str, mode: str) -> Optional[Dict[str, Any]]:
        rec = self.entries.get(sig, {}).get(mode)
        if rec is not None:
            self.stats.memory_hits += 1
            return rec
        if not self.loaded:
            self.load()
            rec = self.entries.get(sig, {}).get(mode)
            if rec is not None:
                self.stats.disk_hits += 1
                return rec
        self.stats.misses += 1
        return None

    def put(self, sig: str, mode: str, record: Dict[str, Any],
            persist: bool = True):
        self.entries.setdefault(sig, {})[mode] = record
        self.stats.stores += 1
        if persist:
            self.save()


# ---------------------------------------------------------------------------
# Operand synthesis (trace-mode measurement)
# ---------------------------------------------------------------------------

def _infer_cols(shapes: Dict[str, Tuple[int, ...]]) -> int:
    for k in ("iv", "vector", "vec", "dense"):
        if k in shapes and shapes[k]:
            return shapes[k][0]
    return 0


def synthesize_operands(binding: Dict[str, Any], seed: int = 0,
                        device=None) -> Optional[Dict[str, Any]]:
    """Real, *semantically valid* stand-ins for the traced binding.

    Trace-mode tuning happens when the graph is built, from the traced
    (fake) tensors: only shapes, dtypes and devices are known, so operands
    are drawn from a seeded generator on the binding's device (or
    ``device``); index-carrying names (``colidx``/``rowstr``/``idx``...)
    get valid index structure so the candidates exercise realistic gathers
    and scatters.  Returns None if an atom's shape is unknown.
    """
    shapes: Dict[str, Tuple[int, ...]] = {}
    dtypes: Dict[str, torch.dtype] = {}
    scalars: Dict[str, Any] = {}
    for k, v in binding.items():
        if isinstance(v, (int, float, bool)):
            scalars[k] = v
            continue
        shape = _shape_of(v)
        if shape is None:
            return None
        shapes[k] = shape
        dtypes[k] = getattr(v, "dtype", torch.float32)
        if device is None and isinstance(v, torch.Tensor):
            device = v.device
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = int(scalars.get("rows", 0))
    nnz = int(scalars.get("nnz", 0))
    experts = int(scalars.get("experts", 0))
    cols = _infer_cols(shapes)

    def ints(hi, shape):
        return torch.randint(0, max(1, hi), shape, generator=gen, device=dev)

    out: Dict[str, Any] = dict(scalars)
    for k, shape in shapes.items():
        if k in ("colidx", "col_ind", "col"):
            t = ints(cols or (shape[-1] if shape else 1), shape)
        elif k in ("rowstr", "row_ptr"):
            # a uniform monotone pointer: rows+1 entries from 0 to nnz
            t = torch.linspace(0, nnz, shape[0], dtype=torch.float64,
                               device=dev).round()
        elif k == "rowidx":
            t = torch.sort(ints(rows, shape).reshape(-1)).values \
                .reshape(shape)
        elif k == "idx":
            t = ints(experts, shape)
        elif k == "perm":
            t = torch.randperm(shape[0], generator=gen, device=dev)
        elif not dtypes[k].is_floating_point:
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev)
        out[k] = t.to(dtypes[k])
    return out


def _is_concrete(v: Any) -> bool:
    """A tensor that holds data: not fake, not on the meta device, not
    batched (under ``torch.func.vmap`` the tuner times stand-ins of the
    per-element shapes, as in a trace: the decision is the per-element
    program's, which unbatched calls share)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return (isinstance(v, torch.Tensor) and not isinstance(v, FakeTensor)
            and v.device.type != "meta" and not levels.batched(v))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

#: decision sources that are real tuning outcomes (measured now or served
#: from the cache): the only ones the pass manager pins.
DEFINITIVE_SOURCES = ("memory", "disk", "measured")


@dataclasses.dataclass
class Decision:
    harness: str
    source: str     # 'memory' | 'disk' | 'measured' | 'fallback'
    sig: str
    # the winning schedule variant; None for a harness without tune space
    schedule: Optional[Dict[str, Any]] = None
    # the winning fused-epilogue realization; None where it is not a choice
    fuse: Optional[bool] = None

    @property
    def definitive(self) -> bool:
        """True when this decision may be pinned: a fallback must stay
        re-tunable on later calls."""
        return self.source in DEFINITIVE_SOURCES

    def as_pin(self) -> Tuple[str, Optional[Dict[str, Any]], Optional[bool]]:
        """The ``(harness, schedule, fuse)`` triple the pass manager pins."""
        return (self.harness, self.schedule, self.fuse)


def _elapsed(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events on the current stream
    for a card, ``perf_counter`` for the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


class CandidateFailure(RuntimeError):
    """A candidate failed its measurement for a reason that does not
    eliminate it (a kernel that does not build or launch).  It names the
    candidate and its variant; the original error is its cause."""

    def __init__(self, harness: str, schedule, fuse, error: BaseException):
        super().__init__(f"autotune candidate {harness!r} "
                         f"({variant_key(schedule, fuse)}) failed: "
                         f"{type(error).__name__}: {error}")
        self.harness = harness
        self.schedule = schedule
        self.fuse = fuse


class Autotuner:
    """Signature-keyed backend selection with an exploration budget.

    ``select`` is the entry point.  It is deterministic once the cache
    holds a winner for the signature (zero re-timing), which is what lets
    trace mode pin the winner into the rewritten graph and a fresh process
    warm-start from disk.
    """

    def __init__(self, registry_fingerprint: str = "",
                 cache: Optional[AutotuneCache] = None,
                 budget: Optional[int] = None,
                 reps: int = 2,
                 max_variants: Optional[int] = None):
        self.registry_fingerprint = registry_fingerprint
        self._cache = cache
        self._cache_injected = cache is not None
        self.budget = budget
        self.reps = reps
        self.max_variants = max_variants
        self.stats = TuneStats()
        self.last_decision: Optional[Decision] = None
        #: the last measurement's candidates: name -> {'steady_s',
        #: 'marshal_s', 'amortized_s', 'schedule', 'fuse'} (None for a
        #: candidate that raised), for reports
        self.last_report: Dict[str, Optional[Dict[str, Any]]] = {}
        # data-plane keys each candidate's calls inserted, during a measure
        self._owned: Dict[str, set] = {}

    # -- cache plumbing ------------------------------------------------------

    @property
    def cache(self) -> AutotuneCache:
        """The persistent cache.  An injected cache is pinned; an
        auto-created one follows LILAC_TORCH_AUTOTUNE_CACHE if it moved."""
        if self._cache_injected:
            return self._cache
        want = default_cache_path()
        if self._cache is None or (self._cache.path != want
                                   and _ENV_PATH in os.environ):
            self._cache = AutotuneCache(
                want, registry_fingerprint=self.registry_fingerprint)
        return self._cache

    def _budget(self) -> int:
        return self.budget if self.budget is not None else exploration_budget()

    def _max_variants(self) -> int:
        return (self.max_variants if self.max_variants is not None
                else variant_cap())

    # -- measurement ---------------------------------------------------------

    @staticmethod
    def _as_runtime(h, binding, ctx):
        """One candidate call as the rewrite runs it: an unfused
        realization pays the bias and activation after the call, a fused
        one in the kernel (``rewrite.call_harness``)."""
        from repro_torch.core.rewrite import call_harness

        return call_harness(h, binding, ctx, ctx.epilogue)

    def _best_of(self, call, device, reps: int) -> float:
        """Best of ``reps`` timed calls after one untimed warm-up call (the
        kernel's build, the data plane's repack)."""
        call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return min(_elapsed(call, device) for _ in range(max(1, reps)))

    def _time_variant(self, h, binding, ctx, mode, operands,
                      schedule: Optional[Dict[str, Any]],
                      reps: int) -> Optional[float]:
        """Time one (harness, schedule) variant; None when it cannot run
        here: the card's memory is too small for it
        (``torch.OutOfMemoryError``) or its harness refuses the operands or
        the schedule (``ValueError``), or an injected fault fired.  It is
        eliminated, not fatal.  Any other error (a kernel that does not
        build or launch) raises :class:`CandidateFailure`: a broken
        candidate must not quietly lose the race.  The data-plane entries
        its calls build are recorded as the harness's, and dropped if it
        was eliminated."""
        prev = ctx.schedule
        ctx.schedule = schedule
        before = ctx.cache.keys() if ctx.cache is not None else set()
        # host mode: steady eager calls through the data plane; trace mode:
        # the jit-safe body (a custom op or plain torch) on the operands
        # synthesized from the traced shapes
        args = operands if mode == "trace" else binding
        try:
            if faults.ACTIVE is not None:
                faults.fail("tune_raise", h.name)
            return self._best_of(lambda: self._as_runtime(h, args, ctx),
                                 torch.device(ctx.platform), reps)
        except (torch.OutOfMemoryError, ValueError, faults.InjectedFault):
            self.stats.eliminated += 1
            if ctx.cache is not None:
                ctx.cache.evict(ctx.cache.keys() - before)
            if ctx.platform == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            return None
        except Exception as e:
            raise CandidateFailure(h.name, schedule, ctx.fuse, e) from e
        finally:
            ctx.schedule = prev
            if ctx.cache is not None:
                self._owned.setdefault(h.name, set()).update(
                    ctx.cache.keys() - before)

    def _drop(self, ctx, name: str) -> None:
        """Drop the data-plane entries candidate ``name`` built: a losing
        repack must not hold memory a later candidate needs."""
        keys = self._owned.pop(name, set())
        if keys and ctx.cache is not None:
            ctx.cache.evict(keys)
            if ctx.platform == "cuda":
                torch.cuda.empty_cache()

    def _settle(self, ctx, keep: Optional[str]) -> None:
        """Drop the data-plane entries of every candidate but ``keep``."""
        for name in [n for n in self._owned if n != keep]:
            self._drop(ctx, name)
        self._owned = {}

    @staticmethod
    def _marshal_cost(h, ctx) -> float:
        """Measured conversion-path seconds of a harness's marshal clauses
        (0.0 without clauses or data plane); asked after timing, when the
        warm-up call has run the repack."""
        if not h.marshal or ctx.cache is None:
            return 0.0
        return float(ctx.cache.estimate_marshal_seconds(h.marshal))

    @staticmethod
    def _reuse(ctx) -> float:
        """Declared calls per matrix change, from the data plane's
        MarshalPolicy: the rate that amortizes a repack."""
        policy = getattr(ctx.cache, "policy", None)
        reuse = getattr(policy, "reuse", None)
        return float(reuse) if reuse else 100.0

    @staticmethod
    def amortized(timings: Dict[str, float], marshal_s: Dict[str, float],
                  reuse: float) -> Dict[str, float]:
        """Repack-amortized seconds per candidate: kernel seconds plus the
        conversion seconds spread over ``reuse`` calls."""
        return {n: t + marshal_s.get(n, 0.0) / max(reuse, 1.0)
                for n, t in timings.items()}

    def _variant_pool(self, ranked: Sequence[Any],
                      epilogue: Optional[str] = None
                      ) -> List[Tuple[Any, Optional[Dict[str, Any]],
                                      Optional[bool]]]:
        """The sweep pool: every candidate's schedule family (one ``None``
        entry when untuned) crossed with its fusion realizations (fused and
        unfused for a ``fuse epilogue`` harness at an epilogue site),
        capped at ``max_variants``.  Each harness's default variant always
        survives the cap; the rest fill round-robin."""
        q = R.shared_quarantine()
        families = []
        for h in ranked:
            scheds = list(h.schedules) or [None]
            fuses = ([True, False] if epilogue is not None
                     and h.fuse_epilogue else [None])
            fam = [(s, f) for s in scheds for f in fuses
                   if not q.is_quarantined(h.implements, h.name,
                                           variant_key(s, f))]
            self.stats.quarantine_skips += len(scheds) * len(fuses) - len(fam)
            if fam:
                families.append((h, fam))
        cap = max(len(families), self._max_variants())
        total = sum(len(f) for _, f in families)
        if total <= cap:
            return [(h, s, f) for h, fam in families for s, f in fam]
        pool = [(h,) + fam[0] for h, fam in families]
        depth = 1
        while len(pool) < cap:
            added = False
            for h, fam in families:
                if depth < len(fam) and len(pool) < cap:
                    pool.append((h,) + fam[depth])
                    added = True
            if not added:
                break
            depth += 1
        return pool

    def _time_pool(self, h, binding, ctx, mode, operands,
                   schedule: Optional[Dict[str, Any]],
                   fuse: Optional[bool], reps: int) -> Optional[float]:
        """Time one (harness, schedule, fuse) pool entry; the fusion choice
        travels on ``ctx.fuse``."""
        prev = ctx.fuse
        ctx.fuse = fuse
        try:
            return self._time_variant(h, binding, ctx, mode, operands,
                                      schedule, reps)
        finally:
            ctx.fuse = prev

    def _sweep(self, pool, binding, ctx, mode, operands,
               marshal_s: Dict[str, float]
               ) -> Dict[Tuple[str, str],
                         Tuple[Any, Optional[Dict], Optional[bool], float]]:
        """Successive halving over the variant pool: single-repetition
        elimination rounds shrink it to the budget, then the survivors get
        steady-state timing.  Returns ``(harness name, variant key) ->
        (harness, schedule, fuse, seconds)`` for the survivors."""
        budget = max(1, self._budget())
        survivors = list(pool)
        while len(survivors) > budget:
            scored = []
            for h, sched, fuse in survivors:
                self.stats.elimination_calls += 1
                t = self._time_pool(h, binding, ctx, mode, operands,
                                    sched, fuse, reps=1)
                self._drop(ctx, h.name)
                if t is not None:
                    scored.append((t, h, sched, fuse))
            if not scored:
                return {}
            scored.sort(key=lambda x: x[0])
            keep = max(budget, (len(scored) + 1) // 2)
            if keep >= len(scored):
                survivors = [(h, s, f) for _, h, s, f in scored]
                break
            survivors = [(h, s, f) for _, h, s, f in scored[:keep]]
        survivors.sort(key=lambda e: pool.index(e))   # a harness's together
        return self._steady(survivors, binding, ctx, mode, operands,
                            marshal_s)

    def _steady(self, pool, binding, ctx, mode, operands,
                marshal_s: Dict[str, float]):
        """Steady-state timing of the pool, a harness's variants in a row.
        After a harness's last variant its marshal seconds are read (host
        mode), and the data plane keeps its entries only while it is the
        cheapest harness so far."""
        out = {}
        best: Optional[Tuple[float, str]] = None
        for j, (h, sched, fuse) in enumerate(pool):
            self.stats.timing_calls += 1
            t = self._time_pool(h, binding, ctx, mode, operands,
                                sched, fuse, reps=self.reps)
            if t is not None:
                out[(h.name, variant_key(sched, fuse))] = (h, sched, fuse, t)
            if j + 1 < len(pool) and pool[j + 1][0] is h:
                continue
            times = [v[3] for v in out.values() if v[0] is h]
            if not times:
                continue
            if mode != "trace":
                marshal_s[h.name] = self._marshal_cost(h, ctx)
            cost = self.amortized({h.name: min(times)}, marshal_s,
                                  self._reuse(ctx))[h.name]
            if best is None or cost < best[0]:
                if best is not None:
                    self._drop(ctx, best[1])
                best = (cost, h.name)
            else:
                self._drop(ctx, h.name)
        return out

    def measure(self, cands: Sequence[Any], binding: Dict[str, Any],
                ctx, mode: str,
                default_name: Optional[str] = None,
                prior_name: Optional[str] = None):
        """Sweep the (harness, schedule, fuse) variants under the budget.
        Returns (winner name, per-harness best seconds, marshal seconds,
        per-harness best schedule, per-variant seconds, per-harness best
        fuse, per-harness surviving (schedule, fuse, seconds) triples); the
        winner minimizes the repack-amortized cost of its best variant.
        ``prior_name`` (the harness of a stale record) ranks first, then
        the platform default, so budget truncation keeps them in play."""
        empty = (None, {}, {}, {}, {}, {}, {})
        ranked = sorted(cands, key=lambda h: (h.name != prior_name,
                                              h.name != default_name))
        ranked = ranked[: max(0, self._budget())]
        operands = None
        if mode == "trace":
            concrete = all(_is_concrete(v) for v in binding.values()
                           if not isinstance(v, (int, float, bool)))
            operands = (dict(binding) if concrete
                        else synthesize_operands(binding,
                                                 device=ctx.platform))
            if operands is None:
                return empty
        self._owned = {}
        pool = self._variant_pool(ranked, ctx.epilogue)
        marshal_s: Dict[str, float] = {}
        try:
            if len(pool) <= max(1, self._budget()):
                measured = self._steady(pool, binding, ctx, mode, operands,
                                        marshal_s)
            else:
                measured = self._sweep(pool, binding, ctx, mode, operands,
                                       marshal_s)
        except CandidateFailure:
            self._settle(ctx, None)     # the broken race keeps nothing
            raise
        self.last_report = {h.name: None for h, _, _ in pool}
        if not measured:
            self._settle(ctx, None)
            return empty
        timings: Dict[str, float] = {}
        schedules: Dict[str, Optional[Dict]] = {}
        fuses: Dict[str, Optional[bool]] = {}
        variant_s: Dict[str, Dict[str, float]] = {}
        variants: Dict[str, List[Tuple[Optional[Dict], Optional[bool],
                                       float]]] = {}
        for (name, vkey), (h, sched, fuse, t) in measured.items():
            variant_s.setdefault(name, {})[vkey] = t
            variants.setdefault(name, []).append((sched, fuse, t))
            if name not in timings or t < timings[name]:
                timings[name] = t
                schedules[name] = sched
                fuses[name] = fuse
        marshal_s = {n: c for n, c in marshal_s.items() if n in timings}
        amort = self.amortized(timings, marshal_s, self._reuse(ctx))
        winner = min(amort, key=amort.get)
        for name in timings:
            self.last_report[name] = {
                "steady_s": timings[name],
                "marshal_s": marshal_s.get(name, 0.0),
                "amortized_s": amort[name], "schedule": schedules[name],
                "fuse": fuses[name]}
        self._settle(ctx, winner)
        return winner, timings, marshal_s, schedules, variant_s, fuses, variants

    # -- selection -----------------------------------------------------------

    def _serve(self, rec, by_name, ctx) -> Optional[Tuple[str, Any, Any]]:
        """The (harness, schedule, fuse) a cached record gives these
        candidates, or None when the record is stale: it pins a schedule
        outside its harness's current family.  A record whose ``reuse``
        differs from the data plane's re-derives its winner from the
        stored seconds, with zero re-timing."""
        name = rec["harness"]
        reuse = self._reuse(ctx)
        timings = rec.get("timings") or {}
        if timings and rec.get("reuse") != reuse:
            amort = self.amortized(
                {n: t for n, t in timings.items() if n in by_name},
                rec.get("marshal_s") or {}, reuse)
            if amort:
                name = min(amort, key=amort.get)
        own = name == rec["harness"]
        schedule = rec.get("schedule") if own \
            else (rec.get("schedules") or {}).get(name)
        fuse = rec.get("fuse") if own else (rec.get("fuses") or {}).get(name)
        if schedule is not None and schedule not in by_name[name].schedules:
            return None
        return name, schedule, fuse

    def select(self, comp: str, fmt: str, platform: str, mode: str,
               cands: Sequence[Any], binding: Dict[str, Any], ctx,
               default_name: Optional[str] = None):
        """Pick a harness from ``cands`` for this call signature and set
        ``ctx.schedule``/``ctx.fuse`` to its variant.  Returns the Harness,
        or None to tell the registry to fall back to its default."""
        if not cands:
            return None
        q = R.shared_quarantine()
        live = [h for h in cands if not q.is_quarantined(comp, h.name)]
        # all quarantined keeps the full set: an answer is still owed, and
        # containment at the call is the enforcement
        if live and len(live) < len(cands):
            self.stats.quarantine_skips += len(cands) - len(live)
            for h in cands:
                if h not in live:
                    R.warn_skip(comp, h.name, "default", "the race runs without it")
            cands = live
        by_name = {h.name: h for h in cands}
        sig = signature_of(comp, fmt, platform, binding, epilogue=ctx.epilogue)
        prior_name = None

        if not autotune_disabled():
            disk_before = self.cache.stats.disk_hits
            rec = self.cache.get(sig, mode)
            if rec is not None and rec.get("harness") in by_name:
                served = self._serve(rec, by_name, ctx)
                if served is not None and R.quarantined(
                        q, comp, served[0], variant_key(served[1],
                                                        served[2])):
                    served = None   # the record predates the incident
                if served is not None:
                    src = ("disk" if self.cache.stats.disk_hits > disk_before
                           else "memory")
                    if src == "memory":
                        self.stats.memory_hits += 1
                    else:
                        self.stats.disk_hits += 1
                    name, ctx.schedule, ctx.fuse = served
                    self.last_decision = Decision(name, src, sig,
                                                  schedule=ctx.schedule,
                                                  fuse=ctx.fuse)
                    return by_name[name]
                if self._budget() > 0:
                    self.stats.remeasures += 1
                    prior_name = rec["harness"]

        if autotune_disabled() or self._budget() <= 0:
            self.stats.fallbacks += 1
            self.last_decision = Decision(default_name or cands[0].name,
                                          "fallback", sig)
            return None

        self.stats.misses += 1
        (winner, timings, marshal_s, schedules, variant_s, fuses,
         variants) = self.measure(cands, binding, ctx, mode,
                                  default_name=default_name,
                                  prior_name=prior_name)
        if winner is None:
            self.stats.fallbacks += 1
            self.last_decision = Decision(default_name or cands[0].name,
                                          "fallback", sig)
            return None
        reuse = self._reuse(ctx)
        record = {"harness": winner,
                  "best_s": timings[winner],
                  "timings": timings,
                  "marshal_s": marshal_s,
                  "reuse": reuse,
                  "amortized_s": self.amortized(timings, marshal_s, reuse),
                  "schedule": schedules.get(winner),
                  "schedules": {n: s for n, s in schedules.items()
                                if s is not None},
                  "fuse": fuses.get(winner),
                  "fuses": {n: f for n, f in fuses.items() if f is not None},
                  "variant_s": variant_s,
                  "variants": {n: [[s, f, t] for s, f, t in vs]
                               for n, vs in variants.items()},
                  "platform": platform,
                  "format": fmt}
        self.cache.put(sig, mode, record, persist=True)
        self.stats.stores += 1
        ctx.schedule = schedules.get(winner)
        ctx.fuse = fuses.get(winner)
        self.last_decision = Decision(winner, "measured", sig,
                                      schedule=ctx.schedule, fuse=ctx.fuse)
        return by_name[winner]

    def record_external(self, comp: str, fmt: str, platform: str, mode: str,
                        binding: Dict[str, Any],
                        timings: Dict[str, float],
                        marshal_s: Optional[Dict[str, float]] = None,
                        reuse: float = 100.0,
                        schedules: Optional[Dict[str, Dict]] = None,
                        epilogue: Optional[str] = None,
                        fuses: Optional[Dict[str, Optional[bool]]] = None,
                        ) -> str:
        """Seed the cache from timings measured elsewhere (a benchmark
        acting as the tuner), in the record ``select`` writes: the winner
        is the repack-amortized argmin at ``reuse``, ``schedules`` and
        ``fuses`` each harness's best variant.  Returns the winner."""
        if not timings:
            raise ValueError("record_external needs at least one timing")
        sig = signature_of(comp, fmt, platform, binding, epilogue=epilogue)
        marshal_s = dict(marshal_s or {})
        amort = self.amortized(timings, marshal_s, reuse)
        winner = min(amort, key=amort.get)
        schedules = dict(schedules or {})
        fuses = {n: f for n, f in (fuses or {}).items() if f is not None}
        self.cache.put(sig, mode, {"harness": winner,
                                   "best_s": timings[winner],
                                   "timings": dict(timings),
                                   "marshal_s": marshal_s,
                                   "reuse": reuse,
                                   "amortized_s": amort,
                                   "schedule": schedules.get(winner),
                                   "schedules": schedules,
                                   "fuse": fuses.get(winner),
                                   "fuses": fuses,
                                   "variant_s": {},
                                   "variants": {},
                                   "platform": platform,
                                   "format": fmt}, persist=True)
        self.stats.stores += 1
        return winner

    # -- introspection -------------------------------------------------------

    def pinned(self) -> Dict[Tuple[str, str], str]:
        """(signature, mode) -> winning harness name, in-memory view."""
        out = {}
        for sig, modes in self.cache.entries.items():
            for mode, rec in modes.items():
                out[(sig, mode)] = rec.get("harness")
        return out
