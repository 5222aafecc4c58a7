"""Serving observability: per-request and per-step counters + percentiles.

Counterpart of ``repro.serve.metrics`` (it imports no framework).

One :class:`ServeMetrics` instance per engine records

* per-request **TTFT** (arrival -> first token, i.e. queueing + prefill),
  end-to-end latency and time-per-token;
* per-step **decode latency**, active-batch size and queue depth;
* **bucket hit/miss** — whether a decode step was served by a shape the
  engine prewarmed (hit) or forced a new signature onto the request path
  (miss: detect/tune/bake happened while a user waited);
* **plan / prewarm counters** — detector invocations and persistent
  plan-cache hits observed during prewarm, so a fleet operator can verify
  the "pay detection once per fleet, not once per replica" economics.

``snapshot()`` returns a JSON-able dict (``save()`` writes it) — the
exported form the serving benchmark and any external scraper consume.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def percentiles(samples: Sequence[float],
                qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` over ``samples`` (empty
    input -> NaNs, so reports stay structurally stable)."""
    out: Dict[str, float] = {}
    arr = np.asarray(list(samples), dtype=np.float64)
    for q in qs:
        key = f"p{q:g}"
        out[key] = float(np.percentile(arr, q)) if arr.size else float("nan")
    return out


def latency_histogram(samples: Sequence[float], bins: int = 12,
                      ) -> Dict[str, List[float]]:
    """Log-spaced latency histogram ``{"edges_s": [...], "counts": [...]}``
    (log-spaced because serving latencies are long-tailed; a linear grid
    puts every bucket boundary below the tail it should resolve)."""
    arr = np.asarray([s for s in samples if s > 0], dtype=np.float64)
    if arr.size == 0:
        return {"edges_s": [], "counts": []}
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        hi = lo * 1.001 + 1e-12
    edges = np.geomspace(lo, hi, bins + 1)
    counts, _ = np.histogram(arr, bins=edges)
    return {"edges_s": [float(e) for e in edges],
            "counts": [int(c) for c in counts]}


@dataclasses.dataclass
class _RequestRecord:
    rid: int
    arrival_t: float
    prompt_len: int = 0
    ttft_s: Optional[float] = None
    tokens: int = 0
    latency_s: Optional[float] = None


class ServeMetrics:
    """Accumulates serving telemetry; cheap enough to always leave on."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.started_t = clock()
        self.requests: Dict[int, _RequestRecord] = {}
        self.decode_step_s: List[float] = []
        self.step_batch: List[int] = []
        self.step_active: List[int] = []
        self.queue_depth: List[int] = []
        self.prefill_s: List[float] = []
        self.bucket_hits = 0
        self.bucket_misses = 0
        self.cache_resizes = 0
        self.evictions = 0
        self.admissions = 0
        self.rejected = 0
        self.prewarm: Dict[str, Any] = {}
        # resilience counters
        self.decode_faults = 0         # decode steps that raised / went NaN
        self.fault_evictions = 0       # requests evicted with .failed set
        self.deadline_evictions = 0    # subset of fault_evictions: deadline
        self.admission_retries = 0     # try_admit backoff sleeps
        self.admission_timeouts = 0    # try_admit gave up within deadline
        self.request_shadow_checks = 0       # finished requests re-decoded solo
        self.request_shadow_divergences = 0  # ... whose token streams differed
        self._resilience_provider = None   # e.g. LilacFunction.resilience_info
        self._request_shadow_provider = None  # AdaptiveShadowRate.snapshot

    # -- recording hooks (called by the engine) --------------------------

    def record_submit(self, rid: int, arrival_t: float, prompt_len: int):
        self.requests[rid] = _RequestRecord(rid, arrival_t, prompt_len)

    def record_rejected(self):
        self.rejected += 1

    def record_admit(self, rid: int, prefill_s: float, ttft_s: float):
        self.admissions += 1
        self.prefill_s.append(prefill_s)
        rec = self.requests.get(rid)
        if rec is not None:
            rec.ttft_s = ttft_s

    def record_step(self, seconds: float, *, batch: int, active: int,
                    queue_depth: int, bucket_hit: bool):
        self.decode_step_s.append(seconds)
        self.step_batch.append(batch)
        self.step_active.append(active)
        self.queue_depth.append(queue_depth)
        if bucket_hit:
            self.bucket_hits += 1
        else:
            self.bucket_misses += 1

    def record_finish(self, rid: int, tokens: int, latency_s: float):
        self.evictions += 1
        rec = self.requests.get(rid)
        if rec is not None:
            rec.tokens = tokens
            rec.latency_s = latency_s

    def record_resize(self):
        self.cache_resizes += 1

    def record_prewarm(self, report: Dict[str, Any]):
        self.prewarm = dict(report)

    def record_decode_fault(self):
        self.decode_faults += 1

    def record_fault_eviction(self, reason: str):
        self.fault_evictions += 1
        if reason == "deadline":
            self.deadline_evictions += 1

    def record_admission_retries(self, n: int):
        self.admission_retries += int(n)

    def record_admission_timeout(self):
        self.admission_timeouts += 1

    def record_request_shadow(self, diverged: bool):
        self.request_shadow_checks += 1
        if diverged:
            self.request_shadow_divergences += 1

    def set_request_shadow_provider(self, fn):
        """``fn() -> dict`` (an ``AdaptiveShadowRate.snapshot``) merged into
        the snapshot's resilience section as ``request_shadow``."""
        self._request_shadow_provider = fn

    def set_resilience_provider(self, fn):
        """``fn() -> dict`` merged into the snapshot's resilience section
        (the engine wires ``LilacFunction.resilience_info`` here so one
        snapshot covers both serving- and compiler-level containment)."""
        self._resilience_provider = fn

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The exported JSON snapshot (the reference's field table,
        docs/serving.md)."""
        done = [r for r in self.requests.values() if r.latency_s is not None]
        tpt = [r.latency_s / r.tokens for r in done if r.tokens]
        ttft = [r.ttft_s for r in self.requests.values()
                if r.ttft_s is not None]
        steps = self.decode_step_s
        occupancy = (float(np.mean(np.asarray(self.step_active)
                                   / np.maximum(self.step_batch, 1)))
                     if steps else float("nan"))
        return {
            "uptime_s": self.clock() - self.started_t,
            "requests": {
                "submitted": len(self.requests),
                "admitted": self.admissions,
                "finished": len(done),
                "rejected": self.rejected,
                "tokens_generated": int(sum(r.tokens for r in done)),
            },
            "ttft_s": percentiles(ttft),
            "time_per_token_s": percentiles(tpt),
            "decode_step_s": {**percentiles(steps),
                              "mean": (float(np.mean(steps)) if steps
                                       else float("nan")),
                              "histogram": latency_histogram(steps)},
            "prefill_s": percentiles(self.prefill_s),
            "queue_depth": percentiles(self.queue_depth, (50, 99)),
            "steps": len(steps),
            "batch_occupancy": occupancy,
            "buckets": {"hits": self.bucket_hits,
                        "misses": self.bucket_misses,
                        "cache_resizes": self.cache_resizes},
            "resilience": self._resilience_section(),
            "prewarm": self.prewarm,
        }

    def _resilience_section(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "decode_faults": self.decode_faults,
            "fault_evictions": self.fault_evictions,
            "deadline_evictions": self.deadline_evictions,
            "admission_retries": self.admission_retries,
            "admission_timeouts": self.admission_timeouts,
            "request_shadow_checks": self.request_shadow_checks,
            "request_shadow_divergences": self.request_shadow_divergences,
        }
        if self._request_shadow_provider is not None:
            try:
                out["request_shadow"] = self._request_shadow_provider()
            except Exception:
                pass
        if self._resilience_provider is not None:
            try:
                out["lilac"] = self._resilience_provider()
            except Exception:
                pass
        return out

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
