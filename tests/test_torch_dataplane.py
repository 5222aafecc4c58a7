"""The data plane's cost-aware eviction, held against the JAX package:
``tests/test_dataplane.py``'s three eviction scenarios (a hot entry
survives churn, the cheap entry goes first, a tiny cache never evicts
its fresh insert), each run on both packages' caches with the same
inputs (numpy arrays for the reference, the same values as tensors for
the port), the hits and misses after every call required equal.
"""
import time

import numpy as np
import pytest
import torch

from repro.core import marshal as JM
from repro_torch.core import marshal as TM

PACKAGES = {"reference": (JM, np.asarray), "port": (TM, torch.from_numpy)}


def _trace(cache):
    return (cache.stats.hits, cache.stats.misses)


def hot_under_churn(M, arr):
    """A hot entry refreshed between 16 cold inserts stays cached."""
    cache = M.MarshalingCache(max_entries=4)
    hot = arr(np.arange(16, dtype=np.float32))
    seen = []
    cache.get("hot", (hot,), lambda: "HOT")
    for i in range(16):
        cache.get("hot", (hot,), lambda: "HOT")
        cold = arr(np.full(16, float(i), np.float32))
        cache.get(f"cold{i}", (cold,), lambda i=i: i)
        seen.append(_trace(cache))
    assert cache.get("hot", (hot,), lambda: "HOT") == "HOT"
    seen.append(_trace(cache))
    return seen


def cheap_goes_first(M, arr):
    """Of two entries of the same age in a window of 2, the one that took
    20 ms to build outlives the cheap one."""
    cache = M.MarshalingCache(max_entries=2)
    cache.EVICT_WINDOW = 2

    def expensive():
        time.sleep(0.02)
        return "exp"

    a, b, c = (arr(np.full(8, v, np.float32)) for v in (1.0, 2.0, 3.0))
    seen = []
    for name, key, fn in (("exp", a, expensive),
                          ("cheap", b, lambda: "cheap"),
                          ("new", c, lambda: "new"),     # one eviction
                          ("exp", a, expensive),         # still cached
                          ("cheap", b, lambda: "cheap")):  # rebuilt
        cache.get(name, (key,), fn)
        seen.append(_trace(cache))
    return seen


def tiny_cache_keeps_its_insert(M, arr):
    """A cache of 2 (below the window of 8) returns each fresh insert, and
    so does the data plane's fallback repack for a format it cannot
    reach."""
    cache = M.MarshalingCache(max_entries=2)
    seen = []
    for i in range(6):
        a = arr(np.full(8, float(i), np.float32))
        got = cache.get(f"k{i}", (a,),
                        lambda i=i: (time.sleep(0.001), i)[1])
        assert got == i
        seen.append(_trace(cache))
    plane = M.DataPlane(policy=M.MarshalPolicy(max_entries=2))
    for i in range(4):
        a = arr(np.full(8, float(i), np.float32))
        slow = lambda i=i: (time.sleep(0.002), f"fb{i}")[1]
        got = plane.ensure("csr_binding", "COO", (a,), {}, fallback=slow)
        assert got == f"fb{i}"
        seen.append(_trace(plane))
    return seen


@pytest.mark.parametrize("scenario", [hot_under_churn, cheap_goes_first,
                                      tiny_cache_keeps_its_insert],
                         ids=lambda f: f.__name__)
def test_eviction_hits_and_misses_match_the_reference(scenario):
    want, got = (scenario(*PACKAGES[p]) for p in ("reference", "port"))
    assert got == want


def test_the_costly_repack_outlives_a_cheap_one():
    """The cheap entry is the one evicted: the costly repack's second
    call is a hit, the cheap one's a miss (the reference's
    ``test_eviction_prefers_cheap_to_recompute``)."""
    seen = cheap_goes_first(*PACKAGES["port"])
    assert seen[3][1] == seen[2][1] and seen[4][1] == seen[3][1] + 1
