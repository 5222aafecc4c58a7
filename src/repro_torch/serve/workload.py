"""Deterministic synthetic serving workloads (counterpart of
``repro.serve.workload``; the ``train/data.py`` idiom:
a pure function of ``(seed, index)``, so benchmarks and tests replay the
exact same traffic with no reader state).

A workload is a sequence of :class:`~repro_torch.serve.scheduler.Request`
blueprints with arrival offsets.  ``rate_rps <= 0`` means a *closed
burst*: every request arrives at t=0 (the batch-formation worst case the
static-batching baseline is measured against); a positive rate draws
exponential inter-arrival gaps (Poisson offered load).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class SyntheticWorkload:
    n_requests: int
    vocab: int
    prompt_len: Tuple[int, int] = (8, 32)        # inclusive range
    new_tokens: Tuple[int, int] = (4, 24)        # inclusive range
    rate_rps: float = 0.0                        # <= 0: closed burst at t=0
    seed: int = 0
    # when set, prompt lengths are drawn from this grid instead of the
    # prompt_len range (the reference prewarms a jitted prefill per length;
    # the port's eager prefill takes any length, and the draws are the same)
    prompt_grid: Tuple[int, ...] = ()

    def _gap(self, j: int) -> float:
        """Exponential inter-arrival gap before request ``j`` — pure in
        ``(seed, j)``, so any prefix of the arrival process replays
        identically regardless of how it is enumerated."""
        return float(np.random.default_rng((self.seed, 7, j)).exponential(
            1.0 / self.rate_rps))

    def request_at(self, i: int) -> Tuple[float, Request]:
        """(arrival offset seconds, request) for index ``i``; pure in
        ``(seed, i)`` except the arrival prefix, which is pure in
        ``(seed, 0..i)``."""
        rng = np.random.default_rng((self.seed, i))
        if self.prompt_grid:
            plen = int(self.prompt_grid[
                int(rng.integers(0, len(self.prompt_grid)))])
        else:
            lo, hi = self.prompt_len
            plen = int(rng.integers(lo, hi + 1))
        nlo, nhi = self.new_tokens
        nnew = int(rng.integers(nlo, nhi + 1))
        prompt = rng.integers(1, max(self.vocab - 1, 2),
                              size=plen).astype(np.int32)
        arrival = 0.0
        if self.rate_rps > 0:
            arrival = float(sum(self._gap(j) for j in range(i + 1)))
        return arrival, Request(prompt=prompt, max_new_tokens=nnew)

    def requests(self) -> List[Tuple[float, Request]]:
        """All ``(arrival, request)`` pairs.  Arrivals accumulate the gap
        sequence once (O(n) total, vs. O(n^2) if each index re-summed its
        own prefix via ``request_at``)."""
        burst = dataclasses.replace(self, rate_rps=0.0)
        out: List[Tuple[float, Request]] = []
        arrival = 0.0
        for i in range(self.n_requests):
            _, req = burst.request_at(i)
            if self.rate_rps > 0:
                arrival += self._gap(i)
            out.append((arrival, req))
        return out

    def __iter__(self) -> Iterator[Tuple[float, Request]]:
        return iter(self.requests())
