"""Request scheduler: continuous (per-step admit/evict) and static batching.

Counterpart of ``repro.serve.scheduler`` (it imports no framework).

The scheduler is deliberately model-free: it owns the waiting queue and
the *slot map* (which request occupies which row of the batched KV cache)
and returns pure bookkeeping decisions — which requests to admit this
step, and which ``(src, dst)`` row moves compact the active prefix after
evictions.  The :class:`~repro_torch.serve.engine.Engine` owns the tensors and
applies those moves with the model's cache hooks; property tests drive
the scheduler against a mock model with no accelerator at all.

Invariant: active requests always occupy slots ``[0, n)`` in slot order
(``active[i]`` lives in cache row ``i``).  Evicting compacts by moving
tail survivors into the holes (swap-remove), so the decode batch can
always be served from a ``[:bucket]`` prefix of the cache.

Two admission modes:

* ``"continuous"`` — admit whenever a slot is free (the tentpole path:
  a finished request's slot is refilled on the very next step);
* ``"static"`` — the classic baseline: admit only when the batch is
  EMPTY, then run that batch until every member finishes.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

_rid_counter = itertools.count()


class SchedulerFull(RuntimeError):
    """The waiting queue is at ``queue_capacity``; the caller must apply
    backpressure (retry later / reject upstream) instead of queueing
    unboundedly."""


@dataclasses.dataclass(eq=False)      # identity equality: requests are
class Request:                        # stateful records, not values
    """One generation request and its lifecycle record."""
    prompt: np.ndarray                    # (L,) int32 token ids
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))
    eos_id: Optional[int] = None
    arrival_t: float = 0.0
    # per-request deadline: seconds from arrival after which the engine
    # evicts the request instead of letting it occupy a slot forever
    # (None = no deadline; a ServeConfig default may fill it at submit)
    deadline_s: Optional[float] = None
    # filled by the engine as the request progresses
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None        # arrival -> first token
    finish_t: Optional[float] = None
    prefill_s: Optional[float] = None
    # the (batch, seq) bucket of each decode step that gave this request a
    # token: what the request shadow's solo replay runs at
    decode_buckets: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    # non-None terminates the request abnormally (decode fault, NaN
    # logits, deadline): ``done`` turns True so the ordinary eviction
    # compaction removes it — only the poisoned request leaves the batch
    failed: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        if self.failed is not None:
            return True
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.tokens
                and self.tokens[-1] == self.eos_id)

    def time_per_token(self) -> Optional[float]:
        """End-to-end seconds per generated token (the serving-latency
        metric the benchmark gates on)."""
        if self.finish_t is None or not self.tokens:
            return None
        return (self.finish_t - self.arrival_t) / len(self.tokens)


class Scheduler:
    """Slot bookkeeping for one replica. See the module docstring."""

    def __init__(self, max_batch: int, *, queue_capacity: int = 1024,
                 mode: str = "continuous"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.queue_capacity = queue_capacity
        self.mode = mode
        self.waiting: Deque[Request] = deque()
        self.active: List[Request] = []    # index == cache slot

    # -- queue -----------------------------------------------------------

    def submit(self, req: Request):
        if len(self.waiting) >= self.queue_capacity:
            raise SchedulerFull(
                f"waiting queue at capacity ({self.queue_capacity})")
        self.waiting.append(req)

    def try_admit(self, req: Request, *, deadline: Optional[float] = None,
                  retries: int = 8, backoff_s: float = 0.005,
                  sleep: Callable[[float], None] = time.sleep,
                  clock: Callable[[], float] = time.monotonic) -> bool:
        """Bounded retry-with-backoff admission: ``submit`` with up to
        ``retries`` attempts, doubling the sleep between them, giving up
        once ``deadline`` seconds (when given) would be exceeded.  Returns
        False instead of raising :class:`SchedulerFull` — the caller
        applies upstream rejection, not an unbounded spin.  ``sleep`` and
        ``clock`` are injectable so tests (and retry-counting callers)
        never actually wait."""
        t0 = clock()
        delay = max(backoff_s, 0.0)
        for attempt in range(max(1, retries)):
            try:
                self.submit(req)
                return True
            except SchedulerFull:
                if attempt + 1 >= max(1, retries):
                    return False
                if deadline is not None \
                        and clock() - t0 + delay > deadline:
                    return False
                sleep(delay)
                delay = delay * 2 if delay > 0 else backoff_s
        return False

    def drain(self) -> List[Request]:
        """Remove and return every request this scheduler holds — active
        (slot order) then waiting (arrival order) — leaving it empty.  The
        front door calls this on a crashed replica to redistribute its
        in-flight work; partial generation state on the returned requests
        is the caller's to reset."""
        out = list(self.active) + list(self.waiting)
        self.active = []
        self.waiting.clear()
        return out

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def idle(self) -> bool:
        return not self.active and not self.waiting

    # -- per-step decisions ---------------------------------------------

    def admissions(self) -> List[Request]:
        """Pop the requests to admit this step (in arrival order).  The
        caller prefills each one and assigns it the next free slot, in
        order, immediately after the current active prefix."""
        if self.mode == "static" and self.active:
            return []                     # static: batch runs to completion
        free = self.max_batch - len(self.active)
        out: List[Request] = []
        while free > 0 and self.waiting:
            out.append(self.waiting.popleft())
            free -= 1
        self.active.extend(out)
        return out

    def evict_finished(self) -> Tuple[List[Request], List[Tuple[int, int]]]:
        """Remove every finished active request.  Returns
        ``(finished, moves)`` where ``moves`` is the ordered list of
        ``(src_slot, dst_slot)`` cache-row moves that re-compact the
        survivors into slots ``[0, n)``.  Moves are safe to apply in
        order (each source is a tail slot not previously overwritten)."""
        finished = [r for r in self.active if r.done]
        if not finished:
            return [], []
        n = len(self.active)
        n_new = n - len(finished)
        # survivors stranded past the new length move into the holes below
        # it; counts match exactly (every hole below n_new strands one
        # survivor above it), and every move's src >= n_new > dst, so no
        # move ever overwrites another move's source.
        low_holes = [i for i in range(n_new) if self.active[i].done]
        tail_survivors = [i for i in range(n_new, n)
                          if not self.active[i].done]
        moves = list(zip(sorted(tail_survivors, reverse=True), low_holes))
        for src, dst in moves:
            self.active[dst] = self.active[src]
        self.active = self.active[:n_new]
        return finished, moves
