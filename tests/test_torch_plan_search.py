"""The port's joint whole-program plan search (repro_torch.core.plan_search),
on the contract of tests/test_plan_search.py:

  * a two-match coupled program where the joint assignment beats the
    independent per-match winners (the shared-repack flip)
  * a single match's search is its per-match winner; beam width 1 is the
    sequential greedy baseline; the prior (the pinned winner) ranks first;
    on seeded random tables the search never costs more than greedy or
    the independent winners
  * the beam-width knob, and beam 0 turning the joint pass off
  * end to end: the pass manager's joint pass flips per-match pins on a
    rigged timer, and a warm plan cache serves the joint pins with zero
    re-search

The port's tuner store is schema 4 only, so the reference's two
schema-3 migration tests have no counterpart.  Each test gets its own plan
cache and tuner store.
"""
import numpy as np
import pytest
import torch

from repro_torch import lilac
from repro_torch.core import plan as P
from repro_torch.core import plan_search as PS
from repro_torch.core.autotune import Autotuner
from repro_torch.core.harness import REGISTRY, HarnessRegistry
from repro_torch.core.marshal import MarshalPolicy
from repro_torch.core.plan_search import (Candidate, MarshalReq,
                                          cost_of_assignment,
                                          greedy_assignment,
                                          independent_assignment, search)
from repro_torch.core.spec import register_spec
from repro_torch.sparse import random as trandom
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.delenv(PS.ENV_BEAM, raising=False)
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()
    yield
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()


# ---------------------------------------------------------------------------
# the search on rigged cost tables
# ---------------------------------------------------------------------------

class _StubGraph:
    """Exact-hit-only conversion graph: a format already built rides free,
    anything else pays the measured full path."""

    def plan_cost(self, starts, dst):
        if dst in starts:
            return starts[dst], (dst,)
        return None


# kernel seconds: 'seg' marshal-free, 'ell' a faster kernel and one repack.
# At reuse 30 and a repack of 0.03 s, each match alone prefers seg (1.8e-3
# against 1e-3 + 0.03/30 = 2e-3), but two matches sharing the repack cost
# 3e-3 together against seg/seg's 3.6e-3.
_REQ = MarshalReq(matrix="A", src="csr_binding", dst="ELL8", full_s=0.03)


def _coupled_table():
    return [Candidate("seg", 1.8e-3),
            Candidate("ell", 1.0e-3, reqs=(_REQ,))]


def test_joint_beats_independent_on_coupled_program():
    tables = [_coupled_table(), _coupled_table()]
    res = search(tables, graph=_StubGraph(), sources={}, reuse=30.0, width=8)
    assert [c.harness for c in res.assignment] == ["ell", "ell"]
    assert res.cost == pytest.approx(3.0e-3)
    assert res.independent_cost == pytest.approx(3.6e-3)
    assert res.joint_vs_independent > 1.0
    ind = independent_assignment(tables, _StubGraph(), {}, 30.0)
    assert ind[1] == pytest.approx(res.independent_cost)
    assert ind[1] == pytest.approx(
        cost_of_assignment(ind[0], _StubGraph(), {}, 30.0))
    assert res.frontier and res.frontier[0]["cost_s"] == pytest.approx(
        res.cost)


def test_single_match_search_is_the_per_match_winner():
    res = search([_coupled_table()], graph=_StubGraph(), sources={},
                 reuse=30.0, width=8)
    assert [c.harness for c in res.assignment] == ["seg"]
    assert res.cost == res.greedy_cost == res.independent_cost


def test_beam_width_one_equals_greedy():
    tables = [_coupled_table(), _coupled_table(), _coupled_table()]
    _, g_cost = greedy_assignment(tables, _StubGraph(), {}, 30.0)
    res = search(tables, graph=_StubGraph(), sources={}, reuse=30.0, width=1)
    assert res.cost == pytest.approx(min(g_cost, res.independent_cost))
    assert res.beam_width == 1


def test_prior_ranks_first_and_wins_ties():
    tables = [[Candidate("prior", 1e-3), Candidate("other", 1e-3)]]
    res = search(tables, reuse=1.0, width=4)
    assert res.assignment[0].harness == "prior"
    # candidates_for_match puts the pinned prior first whatever its time
    rec = {"timings": {"a": 1e-3, "b": 2e-3}, "variants": {}}

    class H:
        def __init__(self, name):
            self.name, self.marshal, self.schedules = name, (), ()

    table = PS.candidates_for_match(None, rec, [H("a"), H("b")], None,
                                    prior=("b", None, None))
    assert [c.harness for c in table] == ["b", "a"]


def test_search_never_costlier_than_the_baselines():
    """On seeded random cost tables (1-4 matches of 1-4 candidates, some
    with a repack of one of two formats): the search never costs more than
    greedy or the independent winners, and its cost is its assignment's."""
    rng = np.random.default_rng(0)
    g = _StubGraph()
    for _ in range(60):
        tables = []
        for _ in range(rng.integers(1, 5)):
            cands = []
            for j in range(rng.integers(1, 5)):
                reqs = ()
                if rng.random() < 0.5:
                    reqs = (MarshalReq("M", "src", ("F1", "F2")[
                        rng.integers(0, 2)], full_s=rng.uniform(0, 0.1)),)
                cands.append(Candidate(f"h{j}", rng.uniform(1e-5, 1e-2),
                                       reqs=reqs))
            tables.append(cands)
        reuse, width = rng.uniform(1.0, 200.0), int(rng.integers(1, 7))
        _, g_cost = greedy_assignment(tables, g, {}, reuse)
        res = search(tables, graph=g, sources={}, reuse=reuse, width=width)
        assert res.cost <= g_cost + 1e-12
        assert res.cost <= res.independent_cost + 1e-12
        assert res.cost == pytest.approx(
            cost_of_assignment(res.assignment, g, {}, reuse))


def test_beam_width_env(monkeypatch):
    assert PS.beam_width() == PS.DEFAULT_BEAM
    monkeypatch.setenv(PS.ENV_BEAM, "3")
    assert PS.beam_width() == 3
    monkeypatch.setenv(PS.ENV_BEAM, "junk")
    assert PS.beam_width() == PS.DEFAULT_BEAM


# ---------------------------------------------------------------------------
# end to end: the pass manager's joint pass on a rigged timer
# ---------------------------------------------------------------------------

def _seg_body(b, ctx):
    row = torch.repeat_interleave(torch.arange(b["rows"]),
                                  torch.diff(b["rowstr"]),
                                  output_size=b["nnz"])
    return torch.zeros(b["rows"]).index_add_(0, row, b["a"] * b["iv"][
        b["colidx"]])


def _ell_body(b, ctx, *, ell=None):
    # the marshaled ELL8 pack arrives as ``ell``; the numbers reuse the
    # CSR arrays (the same result): the repack and its sharing across the
    # two matches are what is under test
    return _seg_body(b, ctx)


def _coupled_registry():
    reg = HarnessRegistry()
    register_spec("""
HARNESS toy.seg implements spmv_csr
  formats CSR;
""", {"toy.seg": _seg_body}, registry=reg)
    register_spec("""
HARNESS toy.ell implements spmv_csr
  formats CSR;
  marshal ell = ell_pack(a, colidx, rowstr|rowidx) from csr_binding to ELL8;
""", {"toy.ell": _ell_body}, registry=reg)
    reg._defaults[("spmv_csr", "cpu")] = "toy.seg"
    return reg


def _rig(monkeypatch, kernel_s, marshal_s):
    """A deterministic timer and marshal estimate, by harness name."""
    def fake_time(self, h, binding, ctx, mode, operands, schedule, reps):
        return kernel_s[h.name]

    monkeypatch.setattr(Autotuner, "_time_variant", fake_time)
    monkeypatch.setattr(
        Autotuner, "_marshal_cost",
        staticmethod(lambda h, ctx: marshal_s.get(h.name, 0.0)))


def _coupled_problem(n=64):
    csr = trandom.random_spd_csr(n, 9, seed=0)
    vec = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                           .astype(np.float32))

    def naive(val, col, row_ptr, v):
        def spmv(x):
            row = torch.repeat_interleave(torch.arange(n), torch.diff(row_ptr),
                                          output_size=val.shape[0])
            return torch.zeros(n).index_add_(0, row, val * x[col])
        return spmv(spmv(v))            # A @ (A @ v): two coupled matches

    return csr, vec, naive


def _compile(naive, reg, **kw):
    return lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu", registry=reg,
                         marshal_policy=MarshalPolicy(reuse=30.0), **kw)


def test_joint_pass_flips_coupled_pins(monkeypatch):
    """Two spmv matches on one matrix: greedy pins the marshal-free
    harness twice; the joint pass flips both to the faster kernel sharing
    one repack and reports the win; the next call runs the joint pins and
    bakes them."""
    reg = _coupled_registry()
    _rig(monkeypatch, {"toy.seg": 1.8e-3, "toy.ell": 1.0e-3},
         {"toy.ell": 0.03})
    csr, vec, naive = _coupled_problem()
    a = (csr.val, csr.col_ind, csr.row_ptr, vec)
    fast = _compile(naive, reg)
    out = fast(*a)
    torch.testing.assert_close(out, naive(*a), atol=1e-4, rtol=1e-4)
    entry = next(iter(fast._compiled.values()))
    assert len(entry.report.matches) == 2
    assert [n for _, n in fast.last_selections] == ["toy.seg", "toy.seg"]
    assert entry.joint_done
    assert entry.pins == {0: ("toy.ell", None, None),
                          1: ("toy.ell", None, None)}
    assert entry.joint["joint_vs_independent"] > 1.0
    assert entry.joint["cost_s"] < entry.joint["independent_cost_s"]
    info = fast.plan_info()
    assert info["joint_searched"] == 1 and info["baked"] == 0
    out2 = fast(*a)
    torch.testing.assert_close(out2, out, atol=1e-4, rtol=1e-4)
    assert [n for _, n in fast.last_selections] == ["toy.ell", "toy.ell"]
    # one (matrix, src, dst) for both matches: the second rides the first
    stats = fast.cache.plan_stats()
    assert sum(s["hits"] for s in stats.values()) >= 1
    assert fast.plan_info()["baked"] == 1


def test_joint_disabled_by_beam_zero(monkeypatch):
    monkeypatch.setenv(PS.ENV_BEAM, "0")
    reg = _coupled_registry()
    _rig(monkeypatch, {"toy.seg": 1.8e-3, "toy.ell": 1.0e-3},
         {"toy.ell": 0.03})
    csr, vec, naive = _coupled_problem()
    fast = _compile(naive, reg)
    fast(csr.val, csr.col_ind, csr.row_ptr, vec)
    entry = next(iter(fast._compiled.values()))
    assert entry.joint_done and entry.joint is None
    assert entry.pins == {0: ("toy.seg", None, None),
                          1: ("toy.seg", None, None)}
    assert fast.plan_info()["baked"] == 1


def test_warm_plan_cache_serves_joint_pins_with_zero_research(
        monkeypatch, tmp_path):
    """A second compiled function over the same program rehydrates the
    joint pins from the plan cache and never runs the search again."""
    reg = _coupled_registry()
    _rig(monkeypatch, {"toy.seg": 1.8e-3, "toy.ell": 1.0e-3},
         {"toy.ell": 0.03})
    csr, vec, naive = _coupled_problem()
    a = (csr.val, csr.col_ind, csr.row_ptr, vec)
    pc = str(tmp_path / "joint_plans.json")
    fast = _compile(naive, reg, plan_cache=pc)
    fast(*a)
    entry = next(iter(fast._compiled.values()))
    assert entry.pins[0][0] == "toy.ell"

    def boom(*args, **kwargs):
        raise AssertionError("the joint search ran on a warm entry")

    monkeypatch.setattr(PS, "optimize_entry", boom)
    timed = reg.autotuner.stats.timing_calls
    again = _compile(naive, reg, plan_cache=pc)
    out = again(*a)
    torch.testing.assert_close(out, naive(*a), atol=1e-4, rtol=1e-4)
    entry2 = next(iter(again._compiled.values()))
    assert entry2.joint_done and entry2.pins == entry.pins
    assert [n for _, n in again.last_selections] == ["toy.ell", "toy.ell"]
    assert entry2.joint is not None
    assert entry2.joint["joint_vs_independent"] > 1.0
    assert reg.autotuner.stats.timing_calls == timed
    assert again.plan_info()["baked"] == 1
