"""Multi-replica front door: hashed routing, health checks, failover.

Counterpart of ``repro.serve.frontdoor``.  One :class:`FrontDoor` owns N
:class:`~repro_torch.serve.engine.Engine`
replicas and is the only thing traffic touches.  Its contract lifts the
single-engine never-worse guarantee to the fleet:

* **routing** — each request lands on a replica chosen by a stable hash
  of its rid over the currently-healthy set, with bounded spill to the
  next healthy replicas when the preferred queue is full;
* **health** — a replica is retired when it crashes outright (any
  exception escaping ``Engine.step``, including the injected
  ``replica_crash`` fault kind) or when its own telemetry condemns it: a
  streak of ``ServeMetrics.decode_faults``-incrementing steps longer
  than ``fault_streak`` means the replica is failing every batch it
  touches and should stop receiving traffic;
* **failover** — a retired replica is drained and its waiting + active
  requests are redistributed to survivors with bounded retry/backoff
  (the engine's ``try_admit`` path).  Partial generation is discarded:
  greedy decode is deterministic, so the survivor regenerates the
  identical token stream.  No request is silently dropped — a request
  that cannot be replaced (no healthy replica, every survivor full, or
  already past its deadline) fails loudly with ``failed="replica_lost"``;
* **shared incidents** — replicas share one process-wide
  :func:`~repro_torch.core.resilience.shared_quarantine` store (the JsonStore
  flock merge supports concurrent writers across processes), so replica
  A's kernel quarantine immediately steers replica B's candidate
  selection.  :meth:`FrontDoor.snapshot` surfaces the fleet view:
  per-replica metrics, aggregated resilience counters, and the shared
  quarantine state.

Replica count defaults to ``LILAC_TORCH_SERVE_REPLICAS`` (see
:func:`default_replicas`); every replica boots off the shared plan
cache, so replicas 2..N pay zero detection.  Replicas built by
:func:`build_fleet` share the model, the parameters and the plan cache on
one card; each has its own compiled decode, plans and KV cache.  On the
card a replica's step that raises anything but an injected fault or out
of memory (``Engine.contains``) raises through the front door: a kernel
of the port that fails is a fault to fix, not a replica to retire.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import faults
from repro_torch.core import resilience as R
from repro_torch.serve.engine import DEFAULT_MAX_STEPS, Engine, ServeConfig
from repro_torch.serve.scheduler import Request

_ENV_REPLICAS = "LILAC_TORCH_SERVE_REPLICAS"
DEFAULT_REPLICAS = 2


def default_replicas() -> int:
    """``LILAC_TORCH_SERVE_REPLICAS`` (default 2, min 1)."""
    try:
        return max(1, int(os.environ.get(_ENV_REPLICAS, DEFAULT_REPLICAS)))
    except ValueError:
        return DEFAULT_REPLICAS


@dataclasses.dataclass
class _Replica:
    """Front-door bookkeeping for one engine."""
    engine: Engine
    index: int
    healthy: bool = True
    reason: Optional[str] = None          # why it was retired
    # decode-fault streak detection: consecutive front-door steps in
    # which this replica's decode_faults counter advanced
    last_decode_faults: int = 0
    fault_streak: int = 0


class FrontDoor:
    """Health-checked request router over a fleet of engine replicas.

    ``engines`` is the fleet (build them sharing one plan cache — the
    default — so later replicas boot with zero detection); or use
    :func:`build_fleet` to construct one from an arch name.

    ``fault_streak`` retires a replica whose decode_faults counter grows
    for that many *consecutive* front-door steps (0 disables telemetry
    health checks; crashes always retire).  ``max_spill`` bounds how many
    alternative healthy replicas a rejected submit tries.
    """

    def __init__(self, engines: Sequence[Engine], *,
                 fault_streak: int = 8, max_spill: Optional[int] = None,
                 clock=time.perf_counter):
        if not engines:
            raise ValueError("FrontDoor needs at least one engine")
        self.replicas = [_Replica(engine=e, index=i)
                         for i, e in enumerate(engines)]
        self.fault_streak = int(fault_streak)
        self.max_spill = max_spill
        self.clock = clock
        #: every request ever accepted by submit(), for accounting
        self.requests: List[Request] = []
        self.assignment: Dict[int, int] = {}      # rid -> replica index
        self._arrival: Dict[int, float] = {}      # rid -> first arrival_t
        # fleet counters
        self.submitted = 0
        self.rejected = 0
        self.failovers = 0          # replicas retired
        self.redistributed = 0      # requests moved to a survivor
        self.lost = 0               # requests failed with "replica_lost"

    # -- routing ---------------------------------------------------------

    def healthy_replicas(self) -> List[_Replica]:
        return [r for r in self.replicas if r.healthy]

    @staticmethod
    def _hash(rid: int) -> int:
        h = hashlib.blake2b(str(rid).encode(), digest_size=8).digest()
        return int.from_bytes(h, "big")

    def submit(self, req: Request) -> bool:
        """Route a request onto the fleet.  Returns False (and counts a
        rejection) only when every healthy replica refused it — the
        caller's backpressure signal."""
        healthy = self.healthy_replicas()
        if not healthy:
            self.rejected += 1
            return False
        start = self._hash(req.rid) % len(healthy)
        spill = len(healthy) if self.max_spill is None \
            else min(len(healthy), self.max_spill + 1)
        for k in range(spill):
            rep = healthy[(start + k) % len(healthy)]
            if rep.engine.submit(req):
                self.assignment[req.rid] = rep.index
                self._arrival.setdefault(req.rid, req.arrival_t)
                if req.rid not in (r.rid for r in self.requests):
                    self.requests.append(req)
                    self.submitted += 1
                return True
        self.rejected += 1
        return False

    # -- fleet step -------------------------------------------------------

    def step(self) -> List[Request]:
        """Advance every healthy replica one engine step.  A replica that
        raises (an uncontained failure — the engine's own containment
        keeps kernel faults from escaping, so what does escape is the
        process-death class, e.g. the injected ``replica_crash``) is
        retired and its requests fail over.  Returns the requests that
        finished this step, fleet-wide."""
        finished: List[Request] = []
        for rep in self.replicas:
            if not rep.healthy:
                continue
            try:
                faults.fail("replica_crash", f"replica{rep.index}")
                finished += rep.engine.step()
            except Exception as e:
                if not rep.engine.contains(e):
                    raise
                self._retire(rep, f"crash: {type(e).__name__}: {e}"[:200])
                continue
            self._health_check(rep)
        return finished

    def _health_check(self, rep: _Replica):
        """Telemetry-driven retirement: a replica whose decode_faults
        counter advances for ``fault_streak`` consecutive steps is failing
        every batch it touches — stop routing to it before it burns its
        whole queue."""
        if self.fault_streak <= 0:
            return
        df = rep.engine.metrics.decode_faults
        rep.fault_streak = rep.fault_streak + 1 \
            if df > rep.last_decode_faults else 0
        rep.last_decode_faults = df
        if rep.fault_streak >= self.fault_streak:
            self._retire(rep, f"unhealthy: decode-fault streak "
                              f"{rep.fault_streak}")

    def _retire(self, rep: _Replica, reason: str):
        rep.healthy = False
        rep.reason = reason
        self.failovers += 1
        self._redistribute(rep.engine.drain())

    def _redistribute(self, drained: Sequence[Request]):
        """Fail a retired replica's in-flight requests over to survivors.

        Already-finished/poisoned records pass through untouched (they are
        accounted), partial generation is reset (the survivor regenerates
        the identical greedy stream), and anything unplaceable — past its
        original deadline, no healthy replica, every survivor full — fails
        loudly with ``failed="replica_lost"``.  Nothing is dropped."""
        now = self.clock()
        for req in drained:
            if req.done:            # finished or already-poisoned record
                if req.finish_t is None:
                    req.finish_t = now
                continue
            # deadline is measured from the ORIGINAL arrival, not the
            # resubmission — failover must not extend a request's budget
            arrival = self._arrival.get(req.rid, req.arrival_t)
            if req.deadline_s is not None \
                    and now - arrival > req.deadline_s:
                self._lose(req, now)
                continue
            req.tokens.clear()
            req.decode_buckets.clear()
            req.ttft_s = None
            req.prefill_s = None
            if self.submit(req):
                self.redistributed += 1
            else:
                self._lose(req, now)

    def _lose(self, req: Request, now: float):
        req.failed = "replica_lost"
        req.finish_t = now
        self.lost += 1

    # -- driving ----------------------------------------------------------

    @property
    def idle(self) -> bool:
        return all(r.engine.scheduler.idle
                   for r in self.replicas if r.healthy)

    def run_until_idle(self, max_steps: int = DEFAULT_MAX_STEPS
                       ) -> List[Request]:
        out: List[Request] = []
        steps = 0
        while not self.idle:
            out += self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet did not drain in {max_steps} steps (livelock?)")
        return out

    def run(self, workload=None, max_steps: int = DEFAULT_MAX_STEPS
            ) -> Dict[str, Any]:
        """Drive a workload (iterable of ``(arrival_offset_s, Request)``)
        plus anything already submitted until the fleet drains; returns
        the fleet snapshot."""
        pending = deque(sorted(workload, key=lambda ar: ar[0])
                        if workload is not None else [])
        start = self.clock()
        steps = 0
        while pending or not self.idle:
            now = self.clock() - start
            while pending and pending[0][0] <= now:
                _, req = pending.popleft()
                self.submit(req)
            if self.idle:
                if pending:
                    wait = pending[0][0] - (self.clock() - start)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"workload did not drain in {max_steps} steps")
        return self.snapshot()

    # -- fleet telemetry ---------------------------------------------------

    def accounted(self) -> bool:
        """True iff every request ever accepted either finished or failed
        with an attributed reason — the no-silent-drops invariant."""
        return all(r.done for r in self.requests)

    def snapshot(self) -> Dict[str, Any]:
        """Fleet-level aggregation: per-replica state + metrics, summed
        resilience counters, the no-silent-drops accounting, and the
        shared quarantine store every replica reports into."""
        finished = [r for r in self.requests
                    if r.done and r.failed is None]
        failed = [r for r in self.requests if r.failed is not None]
        reasons: Dict[str, int] = {}
        for r in failed:
            reasons[r.failed] = reasons.get(r.failed, 0) + 1
        reps = []
        agg = {"decode_faults": 0, "fault_evictions": 0,
               "deadline_evictions": 0, "request_shadow_checks": 0,
               "request_shadow_divergences": 0}
        peak_mult = 1.0
        max_mult = 0.0
        for rep in self.replicas:
            m = rep.engine.metrics
            shadow = rep.engine._request_shadow.snapshot()
            peak_mult = max(peak_mult, shadow["peak_multiplier"])
            max_mult = max(max_mult, shadow["multiplier"])
            agg["decode_faults"] += m.decode_faults
            agg["fault_evictions"] += m.fault_evictions
            agg["deadline_evictions"] += m.deadline_evictions
            agg["request_shadow_checks"] += m.request_shadow_checks
            agg["request_shadow_divergences"] += m.request_shadow_divergences
            reps.append({
                "index": rep.index,
                "healthy": rep.healthy,
                "reason": rep.reason,
                "metrics": m.snapshot(),
            })
        q = R.shared_quarantine()
        return {
            "fleet": {
                "replicas": len(self.replicas),
                "healthy": len(self.healthy_replicas()),
                "submitted": self.submitted,
                "finished": len(finished),
                "failed": len(failed),
                "failed_reasons": reasons,
                "rejected": self.rejected,
                "failovers": self.failovers,
                "redistributed": self.redistributed,
                "replica_lost": self.lost,
                "all_requests_accounted_for": self.accounted(),
                "tokens_generated": int(sum(len(r.tokens)
                                            for r in finished)),
            },
            "resilience": {
                **agg,
                "request_shadow_peak_multiplier": peak_mult,
                "request_shadow_multiplier": max_mult,
            },
            "quarantine": {
                "active": len(q.active()),
                "path": str(q.path),
                "stats": q.stats.as_dict(),
            },
            "replicas": reps,
        }


def build_fleet(arch: str = "olmoe-1b-7b", *, smoke: bool = True,
                seed: int = 0, n_replicas: Optional[int] = None,
                config: Optional[ServeConfig] = None,
                moe_decode_impl: Optional[str] = "naive_flat",
                device=None, **frontdoor_kw) -> FrontDoor:
    """Build one model + params (on ``cuda`` unless ``device`` says
    otherwise), then N engine replicas over them behind a front door.  All
    replicas share the process-wide plan cache (and the model/params —
    replicas differ only in serving state), so only the first prewarm can
    pay detection; the rest rehydrate."""
    from repro_torch.serve.engine import build_engine
    n = n_replicas if n_replicas is not None else default_replicas()
    first = build_engine(arch, smoke=smoke, seed=seed, config=config,
                         moe_decode_impl=moe_decode_impl, device=device)
    engines = [first]
    for _ in range(1, n):
        engines.append(Engine(first.model, first.params, first.config))
    return FrontDoor(engines, **frontdoor_kw)
