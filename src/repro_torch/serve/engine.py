"""The serving engine: continuous batching over a lilac-compiled decode.

Counterpart of ``repro.serve.engine``.  One :class:`Engine` owns one
replica's state — the batched KV cache, the
:class:`~repro_torch.serve.scheduler.Scheduler`, the lilac-compiled decode
step and a :class:`~repro_torch.serve.metrics.ServeMetrics` sink — and
advances it one decode step at a time:

1. **admit** — pop waiting requests into free slots (continuous mode:
   any step with a free slot; static mode: only when the batch drained).
   Each admission runs a prefill at the prompt's own length, copies the
   collected caches into its row of the batched cache, and takes its
   first token from the prefill logits (greedy).
2. **re-bucket** — resize the batched cache to the smallest
   ``(batch, seq-capacity)`` bucket that holds the active set (see
   :mod:`repro_torch.serve.buckets`).  Every bucket pair was prewarmed at
   startup, so the resized shape dispatches onto an already-baked
   :class:`~repro_torch.core.plan.ExecutablePlan` — never detect/tune/bake.
3. **decode** — one batched step with *per-slot* positions (each row of
   the cache is at its own depth); greedy next token per active row.
4. **evict** — finished requests leave; tail survivors compact into the
   holes via ``(src, dst)`` cache-row moves so the active prefix invariant
   holds for the next step.

What differs from the reference, which jits around its compiled decode:

* ``jit_prefill`` compiles the admission plumbing with ``torch.compile``
  (``core.jit.Entry``, the backend ``compile_backend`` names, by default
  inductor on the card and aot_eager on the CPU): the prefill at each
  prompt length, the cache-row install at each (length, bucket) and the
  slot move at each bucket are entries of their own, each one graph at
  static shapes (``fullgraph``: a model whose prefill breaks the graph
  raises), the slot a tensor, so one graph serves every slot.
  ``prewarm()`` compiles them at ``prefill_lengths``; a request at
  another length compiles its prefill and installs on the request path,
  as the reference's jit does, and its entries stay for the engine's
  life (inductor took 151-232 s for OLMoE-1B-7B's full-depth prefill on
  an H100 80GB HBM3 at 700 W: list the traffic's lengths).  An entry
  raises past dynamo's recompile limit and never runs uncompiled.  The
  install and the move write the rows of the engine's cache in place.
  Without ``jit_prefill`` they are the model's ``cache_set_slot`` /
  ``cache_move_slot`` row copies and the prefill runs eagerly; a model
  without tensors (the tests' mock) runs that way.
* The decode keeps the reference's functional signature: it returns a new
  cache, which the engine keeps.  Its baked plan clones its outputs out
  of the CUDA graph's pool, and the first call that brings another cache
  tensor captures again with a static buffer at each cache position,
  which every later call fills with one device copy (``plan_info()``'s
  ``graph_copy_bytes``).  An in-place cache write would instead land in
  that static buffer after a re-bucket, not in the engine's cache.
* The engine runs where the parameters are (``build_engine`` puts them on
  ``cuda`` unless asked for the CPU); a model without tensors (the tests'
  mock) runs on numpy.  On the card only an injected fault or out of
  memory is contained at the decode step: any other error (a kernel that
  does not build or launch, a CUDA error) raises through the engine, as a
  ``cuda.*`` harness's own error raises through ``lilac.compile``.
* The request shadow's solo replay (:meth:`Engine.replay_solo`)
  re-decodes the request alone at the ``(batch, seq)`` bucket of each of
  its batched steps (``Request.decode_buckets``), where the reference
  replays at the smallest buckets: a GEMM or a reduction on the card
  picks its algorithm by shape, so a row's bits depend on the shapes it
  ran at, but not on the other rows.  :meth:`Engine.generate_solo` is the
  reference's solo run at the smallest buckets.

``prewarm()`` walks the bucket grid through
:meth:`~repro_torch.core.pass_manager.LilacFunction.prewarm` before any
traffic, so steady-state decode is plan dispatch only; with a persistent
plan cache shared across replicas, a second replica's prewarm detects
nothing.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults, jit
from repro_torch.core import resilience as R
from repro_torch.models.spec import leaves as tree_leaves, tree_map
from repro_torch.serve.buckets import BucketError, BucketPolicy, \
    default_buckets
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, Scheduler, SchedulerFull

DEFAULT_MAX_STEPS = 200_000


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine configuration (model-independent knobs)."""
    buckets: Optional[BucketPolicy] = None   # None -> LILAC_TORCH_SERVE_BUCKETS
    mode: str = "continuous"                 # continuous | static
    queue_capacity: int = 1024
    eos_id: Optional[int] = None             # default eos for submitted text
    use_lilac: bool = True                   # lilac-compile the decode step
    lilac_mode: str = "host"
    policy: str = "default"
    plan_cache: Any = None                   # forwarded to lilac.compile
    # compile the admission/eviction tensor plumbing (prefill, cache-row
    # install, slot moves) with torch.compile.  True requires a model with
    # tensors; mock models in tests turn it off and the engine calls the
    # model's cache hooks directly.
    jit_prefill: bool = True
    prewarm_on_start: bool = True
    # prompt lengths whose prefill (and install) graphs are compiled during
    # prewarm — requests at other lengths still work, they just pay a
    # first-occurrence compile on the request path
    prefill_lengths: Tuple[int, ...] = ()
    # the torch.compile backend of those graphs; None: inductor on the
    # card, aot_eager on the CPU (jit.backend_for)
    compile_backend: Optional[str] = None
    # default per-request deadline (seconds from arrival): a request past
    # it is evicted with failed="deadline" instead of holding a slot;
    # None = no deadline unless the Request carries its own
    deadline_s: Optional[float] = None
    # when set, submit() admits via Scheduler.try_admit(deadline=...)
    # (bounded retry-with-backoff on a full queue) instead of a single
    # SchedulerFull-raising attempt
    admit_deadline_s: Optional[float] = None
    # request-level shadow verification: the floor fraction of finished
    # requests re-decoded solo on this engine and compared token for token
    # against the batched stream (catches slot mix-ups / compaction bugs
    # the per-dispatch shadow cannot see).  None -> the
    # LILAC_TORCH_REQUEST_SHADOW_RATE env var (default 0 = off); the
    # effective rate is adaptive — divergences spike it, clean checks
    # decay it (repro_torch.core.resilience.AdaptiveShadowRate)
    request_shadow_rate: Optional[float] = None

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


def _device_of(params) -> Optional[torch.device]:
    """The device of the parameters' first tensor (None: no tensors)."""
    if params is None:
        return None
    for _, leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _greedy(logits) -> Tuple[np.ndarray, np.ndarray]:
    """(argmax token, all-finite flag) of each row of ``logits`` on the
    host; a tensor is reduced where it lies and only 2 numbers a row are
    copied back."""
    if isinstance(logits, torch.Tensor):
        flat = logits.reshape(logits.shape[0], -1)
        both = torch.stack([flat.argmax(-1),
                            torch.isfinite(flat).all(-1).long()]).cpu()
        return both[0].numpy(), both[1].numpy().astype(bool)
    flat = np.asarray(logits).reshape(np.shape(logits)[0], -1)
    return np.argmax(flat, axis=-1), np.isfinite(flat).all(axis=1)


class Engine:
    """One serving replica.  ``model`` is anything with the
    :class:`repro_torch.models.factory.Model` surface (prefill / decode /
    init_cache(B, S, device=) / cache_from_prefill / cache_set_slot /
    cache_move_slot / cache_resize); tests drive the scheduler logic with
    an integer mock.
    """

    def __init__(self, model, params, config: Optional[ServeConfig] = None,
                 *, clock=time.perf_counter):
        self.model = model
        self.params = params
        self.config = config or ServeConfig()
        self.buckets = self.config.buckets or default_buckets()
        self.clock = clock
        self.device = _device_of(params)
        self.scheduler = Scheduler(self.buckets.max_batch,
                                   queue_capacity=self.config.queue_capacity,
                                   mode=self.config.mode)
        self.metrics = ServeMetrics(clock=clock)
        self._cache = None
        self._shape: Optional[Tuple[int, int]] = None    # (batch, seq) bucket
        self._prewarmed: set = set()
        self._request_shadow = R.AdaptiveShadowRate(
            R.ENV_REQUEST_SHADOW, floor=self.config.request_shadow_rate)
        self._req_shadow_ctr = 0
        self.metrics.set_request_shadow_provider(self._request_shadow.snapshot)
        if self.config.use_lilac:
            from repro_torch import lilac
            self._decode = lilac.compile(
                model.decode, mode=self.config.lilac_mode,
                policy=self.config.policy,
                plan_cache=self.config.plan_cache, device=self.device)
            self.metrics.set_resilience_provider(self._decode.resilience_info)
        else:
            self._decode = model.decode
        if self.config.jit_prefill and self.device is None:
            raise ValueError("jit_prefill compiles the model's prefill: "
                             "a model without tensors runs with "
                             "jit_prefill=False")
        # (kind, shape...) -> jit.Entry: the compiled prefill at each
        # length, install at each (length, batch, seq) and move at each
        # (batch, seq)
        self._entries: Dict[Tuple, jit.Entry] = {}
        self._warm_compiles = 0
        if self.config.prewarm_on_start and self.config.use_lilac:
            self.prewarm()

    # -- startup ---------------------------------------------------------

    def prewarm(self) -> Dict[str, Any]:
        """Bake one decode plan per bucket-grid point before traffic.

        Each ``(batch, seq)`` signature goes to ``LilacFunction.prewarm``
        as ``(shape, dtype)`` specs of the cache, the tokens and the
        positions (the caller allocates nothing); the returned report
        carries per-bucket ``{baked, detect_calls, from_plan_cache}``.
        With a warm persistent plan cache, ``detect_calls`` is 0 across
        the board.  On the card each plan captures the cache, the tokens
        and the positions into static buffers, which every request-path
        step fills (the decode returns a new cache each step)."""
        sigs = []
        for (b, s) in self.buckets.grid():
            cache = self.model.init_cache(b, s, device="meta")
            sigs.append((self.params,
                         tree_map(lambda a: (tuple(a.shape), a.dtype), cache),
                         ((b, 1), torch.int32), ((b,), torch.int32)))
        report = self._decode.prewarm(*sigs)
        report["grid"] = [list(g) for g in self.buckets.grid()]
        self._prewarmed = set(self.buckets.grid())
        # admission warmup: compile the prefill at each prewarmed length,
        # the cache-row install and the slot move at each bucket now, so
        # that admission and eviction at a prewarmed shape run compiled
        # graphs only
        lengths = list(self.config.prefill_lengths)
        if lengths and self.config.jit_prefill:
            t0 = time.perf_counter()
            prefills = {L: self._prefill(np.zeros(L, np.int32))[1]
                        for L in lengths}
            for (b, s) in self.buckets.grid():
                cache = self.model.init_cache(b, s, device=self.device)
                for L in lengths:
                    if L <= s:
                        self._install(cache, prefills[L], 0, L, (b, s))
                self._move(cache, 0, b - 1, (b, s))
            del prefills, cache
            report["prefill_warm_seconds"] = time.perf_counter() - t0
        report["prefill_warmed"] = lengths
        self._warm_compiles = self.compile_info()["compiles"]
        self.metrics.record_prewarm(report)
        return report

    def compile_info(self) -> Dict[str, Any]:
        """The compiled admission entries (``jit_prefill``): how many, the
        graphs they compiled, their graph breaks and compile seconds, and
        the graphs compiled since ``prewarm()`` ended (on the request
        path), with each entry's counts."""
        stats = [e.stats() | {"key": list(k)}
                 for k, e in self._entries.items()]
        total = sum(st["compiles"] for st in stats)
        return {"entries": len(stats), "compiles": total,
                "request_path_compiles": total - self._warm_compiles,
                "graph_breaks": sum(st["graph_breaks"] for st in stats),
                "compile_seconds": sum(st["compile_seconds"]
                                       for st in stats),
                "by_entry": stats}

    # -- request intake --------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue a request; False (and a rejection metric) when the
        queue is full or the request cannot fit any bucket.  With
        ``config.admit_deadline_s`` set, a full queue is retried with
        bounded backoff (``Scheduler.try_admit``) before rejecting."""
        if req.eos_id is None:
            req.eos_id = self.config.eos_id
        if req.deadline_s is None:
            req.deadline_s = self.config.deadline_s
        try:
            self.buckets.seq_bucket(req.prompt_len + req.max_new_tokens)
        except BucketError:
            self.metrics.record_rejected()
            return False
        if self.config.admit_deadline_s is not None:
            retries = 0

            def _sleep(dt, _sleep=time.sleep):
                nonlocal retries
                retries += 1
                _sleep(dt)

            ok = self.scheduler.try_admit(
                req, deadline=self.config.admit_deadline_s, sleep=_sleep)
            if retries:
                self.metrics.record_admission_retries(retries)
            if not ok:
                self.metrics.record_admission_timeout()
                self.metrics.record_rejected()
                return False
        else:
            try:
                self.scheduler.submit(req)
            except SchedulerFull:
                self.metrics.record_rejected()
                return False
        req.arrival_t = self.clock()
        self.metrics.record_submit(req.rid, req.arrival_t, req.prompt_len)
        return True

    # -- one engine step --------------------------------------------------

    def step(self) -> List[Request]:
        """Admit -> re-bucket -> prefill admissions -> decode -> evict.
        Returns the requests that finished during this step."""
        finished: List[Request] = []
        self._expire_deadlines()
        admitted = self.scheduler.admissions()
        if self.scheduler.active:
            self._fit_buckets()
        if admitted:
            self._admit(admitted)
            finished += self._evict()
        if self.scheduler.active:
            self._decode_once()
            finished += self._evict()
        return finished

    def run_until_idle(self, max_steps: int = DEFAULT_MAX_STEPS
                       ) -> List[Request]:
        out: List[Request] = []
        steps = 0
        while not self.scheduler.idle:
            out += self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   f"steps (livelock?)")
        return out

    def run(self, workload=None, max_steps: int = DEFAULT_MAX_STEPS
            ) -> Dict[str, Any]:
        """Drive a workload (iterable of ``(arrival_offset_s, Request)``)
        plus anything already submitted until drained; returns the metrics
        snapshot."""
        pending = deque(sorted(workload, key=lambda ar: ar[0])
                        if workload is not None else [])
        start = self.clock()
        steps = 0
        while pending or not self.scheduler.idle:
            now = self.clock() - start
            while pending and pending[0][0] <= now:
                _, req = pending.popleft()
                self.submit(req)
            if self.scheduler.idle:
                if pending:
                    wait = pending[0][0] - (self.clock() - start)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"workload did not drain in {max_steps} "
                                   f"steps")
        return self.metrics.snapshot()

    def drain(self) -> List[Request]:
        """Remove and return every in-flight request (active in slot
        order, then waiting in arrival order), resetting the replica's
        batch state.  The front door calls this on a failed replica; the
        caller discards partial generation before resubmitting — greedy
        decode is deterministic, so a re-run on a survivor regenerates
        the identical token stream."""
        out = self.scheduler.drain()
        self._cache = None
        self._shape = None
        return out

    def contains(self, e: BaseException) -> bool:
        """Whether ``e``, raised by a decode step, is a fault to contain
        (the front door's too): anything off the card; on it only an
        injected fault or out of memory."""
        return (self.device is None or self.device.type != "cuda"
                or R.injected_or_oom(e))

    def replay_solo(self, req: Request) -> List[int]:
        """Re-decode a finished request's stream solo ON THIS ENGINE: its
        prefill, then each decode step alone in row 0 of a cache at the
        ``(batch, seq)`` bucket that step ran at in the batch, through the
        same compiled decode.  Returns exactly ``len(req.tokens)`` greedy
        tokens — the reference the request-level shadow compares
        against."""
        n = len(req.tokens)
        shapes = list(req.decode_buckets[:n - 1]) or [
            (self.buckets.batch_bucket(1),
             self.buckets.seq_bucket(req.prompt_len + req.max_new_tokens))]
        return self._solo(req.prompt, n, shapes)

    def generate_solo(self, prompt, max_new_tokens: int, *,
                      eos_id: Optional[int] = None) -> List[int]:
        """Run one request alone, as a fresh engine (same model, params
        and buckets) would: the smallest batch bucket and the request's
        own seq bucket, until ``max_new_tokens`` or ``eos_id`` — the
        per-request reference stream of the batching property tests."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        try:
            shape = (self.buckets.batch_bucket(1),
                     self.buckets.seq_bucket(len(prompt) + max_new_tokens))
        except BucketError:
            raise ValueError("request does not fit any bucket") from None
        return self._solo(prompt, max_new_tokens, [shape], eos_id=eos_id)

    # -- internals --------------------------------------------------------

    def _as_input(self, a: np.ndarray):
        return a if self.device is None else \
            torch.from_numpy(a).to(self.device)

    def _entry(self, key: Tuple, fn) -> jit.Entry:
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = jit.Entry(
                fn, self.config.compile_backend
                or jit.backend_for(self.device),
                name="/".join(map(str, key)))
        return entry

    def _prefill(self, prompt: np.ndarray):
        tokens = self._as_input(prompt[None, :])
        if not self.config.jit_prefill:
            return self.model.prefill(self.params, {"tokens": tokens})
        model = self.model

        def prefill(params, tokens):
            return model.prefill(params, {"tokens": tokens})
        return self._entry(("prefill", len(prompt)), prefill)(self.params,
                                                              tokens)

    def _slot(self, i: int) -> torch.Tensor:
        return torch.tensor([i], dtype=torch.long, device=self.device)

    def _install(self, cache, caches, slot: int, L: int,
                 bucket: Tuple[int, int]):
        """Write the prefill's caches (length ``L``) into row ``slot`` of
        ``cache`` (at ``bucket``, its (batch, seq capacity)); returns
        ``cache``."""
        model, S = self.model, bucket[1]
        if not self.config.jit_prefill:
            return model.cache_set_slot(cache, slot,
                                        model.cache_from_prefill(caches, L, S))

        def install(cache, caches, slot):
            row = model.cache_from_prefill(caches, L, S)
            tree_map(lambda full, one: full.index_copy_(
                0, slot, one.to(full.dtype)), cache, row)
        self._entry(("install", L) + tuple(bucket), install)(
            cache, caches, self._slot(slot))
        return cache

    def _move(self, cache, src: int, dst: int, bucket: Tuple[int, int]):
        """Copy row ``src`` over row ``dst`` of ``cache`` (at ``bucket``);
        returns ``cache``."""
        if not self.config.jit_prefill:
            return self.model.cache_move_slot(cache, src, dst)

        def move(cache, src, dst):
            tree_map(lambda a: a.index_copy_(0, dst, a.index_select(0, src)),
                     cache)
        self._entry(("move",) + tuple(bucket), move)(
            cache, self._slot(src), self._slot(dst))
        return cache

    def _solo(self, prompt, n: int, shapes, *, eos_id=None) -> List[int]:
        """``n`` greedy tokens of ``prompt`` decoded alone in row 0, step
        i at ``shapes[i]`` (the last shape repeats), stopping at
        ``eos_id``."""
        B, S = shapes[0]
        logits, caches = self._prefill(prompt)
        cache = self._install(self.model.init_cache(B, S, device=self.device),
                              caches, 0, len(prompt), (B, S))
        toks = [int(_greedy(logits)[0][0])]
        while len(toks) < n and (eos_id is None or toks[-1] != eos_id):
            b, s = shapes[min(len(toks) - 1, len(shapes) - 1)]
            if (b, s) != (B, S):
                cache = self.model.cache_resize(cache, B=b, max_seq=s)
                B, S = b, s
            tokens = np.zeros((B, 1), np.int32)
            pos = np.zeros((B,), np.int32)
            tokens[0, 0] = toks[-1]
            pos[0] = len(prompt) + len(toks) - 1
            logits, cache = self._decode(self.params, cache,
                                         self._as_input(tokens),
                                         self._as_input(pos))
            toks.append(int(_greedy(logits)[0][0]))
        return toks

    def _fit_buckets(self):
        active = self.scheduler.active
        need_s = max(r.prompt_len + r.max_new_tokens for r in active)
        target = (self.buckets.batch_bucket(len(active)),
                  self.buckets.seq_bucket(need_s))
        if target == self._shape:
            return
        if self._cache is None:
            self._cache = self.model.init_cache(*target, device=self.device)
        else:
            self._cache = self.model.cache_resize(
                self._cache, B=target[0], max_seq=target[1])
            self.metrics.record_resize()
        self._shape = target

    def _admit(self, admitted: Sequence[Request]):
        for req in admitted:
            slot = self.scheduler.active.index(req)
            t0 = self.clock()
            logits, caches = self._prefill(req.prompt)
            self._cache = self._install(self._cache, caches, slot,
                                        req.prompt_len, self._shape)
            req.tokens.append(int(_greedy(logits)[0][0]))
            req.prefill_s = self.clock() - t0
            req.ttft_s = self.clock() - req.arrival_t
            self.metrics.record_admit(req.rid, req.prefill_s, req.ttft_s)

    def _decode_once(self):
        tb, ts = self._shape
        active = self.scheduler.active
        tokens = np.zeros((tb, 1), np.int32)
        pos = np.zeros((tb,), np.int32)
        for i, r in enumerate(active):
            tokens[i, 0] = r.tokens[-1]
            # the new token is written at the row's current depth
            pos[i] = r.prompt_len + len(r.tokens) - 1
        t0 = self.clock()
        try:
            if faults.ACTIVE is not None:
                # attribute the injected fault to a rotating batch slot so
                # chaos runs exercise eviction at every position
                slot = faults.ACTIVE.attempts(
                    "decode_raise", "decode") % len(active)
                faults.fail("decode_raise", "decode", slot=slot)
            logits, cache = self._decode(self.params, self._cache,
                                         self._as_input(tokens),
                                         self._as_input(pos))
            nxt, finite = _greedy(logits)
        except Exception as e:   # containment boundary: poison one slot
            if not self.contains(e):
                raise
            slot = getattr(e, "slot", None)
            if not isinstance(slot, int) or not 0 <= slot < len(active):
                slot = len(active) - 1
            active[slot].failed = \
                f"decode: {type(e).__name__}: {e}"[:200]
            self.metrics.record_decode_fault()
            # the cache was NOT reassigned, so this step is a no-op for
            # the survivors: they redo the identical decode next step and
            # their streams stay bit-identical to a fault-free run
            return
        self._cache = cache
        dt = self.clock() - t0
        if faults.ACTIVE is not None and faults.check("decode_nan", "decode"):
            slot = faults.ACTIVE.attempts("decode_nan", "decode") \
                % len(active)
            finite = finite.copy()
            finite[slot] = False
        # per-row finite check: a NaN/Inf row fails only that request; the
        # cache row itself is overwritten or compacted away at eviction
        for i, r in enumerate(active):
            if not finite[i]:
                r.failed = "non-finite decode logits"
                self.metrics.record_decode_fault()
                continue
            r.tokens.append(int(nxt[i]))
            r.decode_buckets.append((tb, ts))
        self.metrics.record_step(
            dt, batch=tb, active=len(active),
            queue_depth=self.scheduler.queue_depth,
            bucket_hit=(tb, ts) in self._prewarmed)

    def _expire_deadlines(self):
        """Evict requests past their per-request deadline.  Active ones
        are marked failed and leave through the ordinary compaction;
        waiting ones are dropped from the queue directly (they hold no
        cache slot, so no moves are needed)."""
        now = self.clock()

        def _past(r: Request) -> bool:
            return (r.deadline_s is not None and r.failed is None
                    and r.arrival_t and now - r.arrival_t > r.deadline_s)

        for r in self.scheduler.active:
            if _past(r):
                r.failed = "deadline"
        expired = [r for r in self.scheduler.waiting if _past(r)]
        if expired:
            self.scheduler.waiting = deque(
                r for r in self.scheduler.waiting if r not in expired)
            for r in expired:
                r.failed = "deadline"
                r.finish_t = now
                self.metrics.record_fault_eviction("deadline")
                self.metrics.record_finish(r.rid, len(r.tokens),
                                           now - r.arrival_t)

    def _evict(self) -> List[Request]:
        finished, moves = self.scheduler.evict_finished()
        for src, dst in moves:
            self._cache = self._move(self._cache, src, dst, self._shape)
        now = self.clock()
        for r in finished:
            r.finish_t = now
            if r.failed is not None:
                self.metrics.record_fault_eviction(r.failed)
            self.metrics.record_finish(r.rid, len(r.tokens),
                                       now - r.arrival_t)
            if r.failed is None and r.tokens:
                self._maybe_shadow_request(r)
        return finished

    def _maybe_shadow_request(self, req: Request):
        """Request-level shadow verification on a deterministic stratified
        sample of finished requests (same scheme as the dispatch-level
        shadow: rate r checks finish n iff the integer part of n*r
        advances).  The batched stream is compared token for token with a
        solo replay on this same engine — any difference means the
        *batched path* (slot map, compaction, cache moves) corrupted the
        request, which per-dispatch shadowing of the decode fn cannot
        see.  Divergence feeds the compiled decode's quarantine→re-tune
        path and spikes both adaptive rates."""
        r = self._request_shadow.effective()
        if r <= 0.0:
            return
        self._req_shadow_ctr = n = self._req_shadow_ctr + 1
        if int(n * r) == int((n - 1) * r):
            return
        try:
            solo = self.replay_solo(req)
        except Exception as e:
            if not self.contains(e):
                raise
            return      # the replay itself failed; never punish the served path
        diverged = (solo != list(req.tokens)
                    or faults.check("shadow_diverge", "request"))
        self.metrics.record_request_shadow(diverged)
        if not diverged:
            self._request_shadow.clean()
            return
        self._request_shadow.spike("request shadow divergence")
        report = getattr(self._decode, "report_divergence", None)
        if report is not None:
            report(reason=f"request-shadow divergence (rid {req.rid})")


def build_engine(arch: str = "olmoe-1b-7b", *, smoke: bool = True,
                 seed: int = 0, config: Optional[ServeConfig] = None,
                 moe_decode_impl: Optional[str] = "naive_flat",
                 device=None) -> Engine:
    """Convenience constructor: registry arch -> (smoke-sized) model ->
    parameters from ``seed`` on ``device`` (``cuda`` unless the caller
    asks for the CPU; without a card that raises) -> Engine.
    ``moe_decode_impl="naive_flat"`` makes the decode step carry the
    canonical dense-dispatch MoE so the LiLAC detector can target it;
    None keeps the arch default."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.core.pass_manager import resolve_platform
    from repro_torch.models.factory import build_model

    dev = torch.device(resolve_platform(None, device or "cuda"))
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if moe_decode_impl is not None and cfg.moe_experts:
        cfg = cfg.replace(moe_decode_impl=moe_decode_impl)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    return Engine(model, params, config)
