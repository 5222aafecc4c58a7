"""Fail-safe acceleration in the port: chaos injection, contained
execution, harness quarantine and shadow verification.

One counterpart for each test of the reference's ``tests/test_resilience.py``
that does not involve serving, on the same seeded problem (the JAX
package's ``random_csr``), plus tests of what the card adds: sticky CUDA
errors, no sync on the plan path, the containment warning, and the dot and
GEMV harnesses under faults.  The contract: ``lilac.compile(f)`` is never
worse than ``f`` — under any injected fault the caller sees the uncompiled
program's answer and no exception, and the failing (harness, variant) is
quarantined and persisted.  The oracle is the uncompiled torch program,
which equals the reference's to 2e-4.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import faults
from repro_torch.core import resilience as R
from repro_torch.core.harness import REGISTRY
from repro_torch.core.plan import reset_shared_plan_caches
from repro_torch.core.resilience import (LilacContainmentWarning,
                                         QuarantineStore, outputs_close,
                                         reset_shared_quarantine,
                                         shared_quarantine)

ROWS, COLS = 64, 48


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """Every store in this test's directory, no ambient chaos plan, no
    shadow checks, a fresh tuner."""
    for name, file in (("AUTOTUNE", "autotune"), ("PLAN", "plans"),
                       ("QUARANTINE", "quarantine")):
        monkeypatch.setenv(f"LILAC_TORCH_{name}_CACHE",
                           str(tmp_path / f"{file}.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE", "LILAC_TORCH_PLAN_CACHE_DISABLE",
              "LILAC_TORCH_AUTOTUNE_DISABLE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    reset_shared_plan_caches()
    REGISTRY.reset_autotuner()
    yield
    faults.load_env()
    reset_shared_quarantine()
    reset_shared_plan_caches()
    REGISTRY.reset_autotuner()


@pytest.fixture(scope="module")
def problem():
    """(the reference's CSR, the vector, the same as tensors): one set of
    tensors for every call, as a solver passes its matrix."""
    csr = random_csr(ROWS, COLS, density=0.12, seed=1)
    rng = np.random.default_rng(2)
    vec = rng.standard_normal(COLS).astype(np.float32)
    return csr, vec, tuple(torch.from_numpy(np.array(a)) for a in
                           (csr.val, csr.col_ind, csr.row_ptr, vec))


def naive_spmv(val, col, row_ptr, vec):
    row = torch.repeat_interleave(torch.arange(ROWS), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    return torch.zeros(ROWS).index_add_(0, row, val * vec[col])


def naive_spmv_jax(val, col, row_ptr, vec):
    import jax

    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * vec[col], row, num_segments=ROWS)


def _args(problem):
    return problem[2]


def _assert_oracle(out, problem):
    torch.testing.assert_close(out, naive_spmv(*_args(problem)),
                               atol=2e-4, rtol=2e-4)


def test_the_oracle_is_the_reference(problem):
    csr, vec, _ = problem
    want = np.asarray(naive_spmv_jax(csr.val, csr.col_ind, csr.row_ptr,
                                     jnp.asarray(vec)))
    np.testing.assert_allclose(naive_spmv(*_args(problem)).numpy(), want,
                               atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# fault harness mechanics
# ---------------------------------------------------------------------------

def test_parse_spec_grammar():
    spec = "kernel_raise:cuda.ell:0.5, nan_output:* ,cache_torn_write"
    rules = faults.parse_spec(spec)
    assert [(r.kind, r.site, r.prob) for r in rules] == [
        ("kernel_raise", "cuda.ell", 0.5),
        ("nan_output", "*", 1.0),
        ("cache_torn_write", "*", 1.0)]
    assert [(r.kind, r.site, r.prob) for r in rules] \
        == [(r.kind, r.site, r.prob) for r in jfaults.parse_spec(spec)]
    assert faults.KINDS == jfaults.KINDS
    for bad in ("no_such_kind", "kernel_raise:*:1.5", "kernel_raise:*:zero"):
        with pytest.raises(faults.FaultSpecError):
            faults.parse_spec(bad)


def test_fault_plan_is_deterministic():
    """Same (seed, call sequence) -> the same fired log; no RNG state."""
    logs = []
    for _ in range(2):
        plan = faults.FaultPlan(faults.parse_spec("kernel_raise:*:0.5"),
                                seed=7)
        for _ in range(64):
            plan.fires("kernel_raise", "cuda.ell")
        logs.append(list(plan.fired))
    assert logs[0] == logs[1]
    assert 0 < len(logs[0]) < 64
    other = faults.FaultPlan(faults.parse_spec("kernel_raise:*:0.5"), seed=8)
    for _ in range(64):
        other.fires("kernel_raise", "cuda.ell")
    assert other.fired != logs[0]


def test_fires_like_the_reference():
    """A seed fires the same decisions in both packages for the same site
    names: 4 seeds x 3 kinds x 4 sites x 25 attempts = 1,200."""
    spec = "kernel_raise:*:0.37,nan_output:cuda.*:0.6,tune_raise:*:0.1"
    sites = ("cuda.ell", "cuda.bcsr", "torch.segment", "plans")
    for seed in (0, 3, 11, 65535):
        mine = faults.FaultPlan(faults.parse_spec(spec), seed=seed)
        ref = jfaults.FaultPlan(jfaults.parse_spec(spec), seed=seed)
        for _ in range(25):
            for kind in ("kernel_raise", "nan_output", "tune_raise"):
                for site in sites:
                    assert mine.fires(kind, site) == ref.fires(kind, site)
        assert mine.fired == ref.fired and mine.fired


def test_inject_restores_previous_plan():
    assert faults.ACTIVE is None
    with faults.inject("nan_output"):
        assert faults.ACTIVE is not None
        with faults.inject("kernel_raise") as inner:
            assert faults.ACTIVE is inner
        assert faults.ACTIVE is not None and faults.ACTIVE is not inner
    assert faults.ACTIVE is None


def test_site_pattern_addressing():
    with faults.inject("kernel_raise:cuda.*") as plan:
        assert not faults.check("kernel_raise", "torch.segment")
        with pytest.raises(faults.InjectedFault) as ei:
            faults.fail("kernel_raise", "cuda.ell", slot=3)
        assert ei.value.slot == 3 and ei.value.site == "cuda.ell"
    assert plan.fired == [("kernel_raise", "cuda.ell", 0)]


# ---------------------------------------------------------------------------
# chaos sweep: every fault class -> oracle numerics, zero exceptions
# ---------------------------------------------------------------------------

CHAOS_SPECS = [
    "kernel_raise:*",
    "nan_output:*",
    "marshal_raise:*",
    "tune_raise:*",
    "bake_raise:*",
    "cache_torn_write:*",
    ("kernel_raise:*:0.5,nan_output:*:0.3,marshal_raise:*:0.4,"
     "tune_raise:*:0.5,bake_raise:*:0.5,cache_torn_write:*:0.5"),
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_sweep_is_oracle_correct(problem, spec):
    """With the fault class active at every site, compile + two calls
    (cold, steady state) stay correct and raise nothing."""
    with faults.inject(spec, seed=3) as plan:
        fast = lilac.compile(naive_spmv, mode="host", policy="autotune",
                             platform="cpu")
        _assert_oracle(fast(*_args(problem)), problem)
        _assert_oracle(fast(*_args(problem)), problem)
    assert plan.fired
    info = fast.resilience_info()
    if any(k in spec for k in ("kernel_raise", "nan_output")):
        c = info["containment"]
        assert c["contained_exceptions"] + c["nonfinite_outputs"] > 0
        assert c["quarantines"] > 0


def test_chaos_seeds_rotate(problem):
    for seed in (0, 11, 29):
        reset_shared_quarantine()
        with faults.inject("kernel_raise:*:0.6,nan_output:*:0.4",
                           seed=seed):
            fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
            _assert_oracle(fast(*_args(problem)), problem)


def test_chaos_hypothesis_sweep(problem):
    """Random rule subsets, probabilities and seeds never break the
    contract."""
    from hypothesis import given, settings, strategies as st

    core_kinds = ["kernel_raise", "nan_output", "marshal_raise",
                  "tune_raise", "bake_raise", "cache_torn_write"]

    @settings(max_examples=8, deadline=None)
    @given(kinds=st.sets(st.sampled_from(core_kinds), min_size=1),
           prob=st.floats(0.2, 1.0),
           seed=st.integers(0, 2 ** 16))
    def check(kinds, prob, seed):
        reset_shared_quarantine()
        spec = ",".join(f"{k}:*:{prob:.3f}" for k in sorted(kinds))
        with faults.inject(spec, seed=seed):
            fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
            _assert_oracle(fast(*_args(problem)), problem)

    check()


def test_all_candidates_quarantined_still_correct(problem):
    """A store that bans every harness leaves the uncompiled program."""
    q = shared_quarantine()
    for h in REGISTRY.harnesses_for("spmv_csr"):
        q.add("spmv_csr", h.name, reason="test: pre-banned")
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    _assert_oracle(fast(*_args(problem)), problem)


# ---------------------------------------------------------------------------
# quarantine store
# ---------------------------------------------------------------------------

def test_quarantine_persistence_roundtrip(tmp_path):
    path = tmp_path / "q.json"
    q1 = QuarantineStore(path)
    key = q1.add("spmv_csr", "cuda.ell", "rows_per_slab=64|fused",
                 reason="exception: boom", site="cuda.ell")
    assert q1.is_quarantined("spmv_csr", "cuda.ell", "rows_per_slab=64|fused")
    assert not q1.is_quarantined("spmv_csr", "cuda.ell")   # other variant
    q2 = QuarantineStore(path)               # a fresh process's view
    assert q2.is_quarantined("spmv_csr", "cuda.ell", "rows_per_slab=64|fused")
    rec = q2.active()[key]
    assert rec["reason"].startswith("exception: boom")
    assert rec["site"] == "cuda.ell" and rec["ttl"] > 0
    assert QuarantineStore().path.parent.name == "lilac-torch" or \
        os.environ.get("LILAC_TORCH_QUARANTINE_CACHE")


def test_quarantine_ttl_expiry(tmp_path, monkeypatch):
    q = QuarantineStore(tmp_path / "q.json")
    q.add("c", "h", reason="transient", ttl=1e-9)
    q.add("c", "h2", reason="permanent", ttl=-1.0)     # <= 0: never expires
    assert not q.is_quarantined("c", "h")              # lazily purged
    assert q.stats.expired == 1
    assert q.is_quarantined("c", "h2")
    assert list(q.active()) == [q.key_of("c", "h2")]
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_TTL", "5")
    q.add("c", "h3", reason="env ttl")
    assert q.active()[q.key_of("c", "h3")]["ttl"] == 5.0


def test_quarantine_survives_torn_write(tmp_path):
    """cache_torn_write at the store itself: the torn file is moved
    aside and the next reader starts fresh."""
    path = tmp_path / "quarantine.json"
    with faults.inject("cache_torn_write:quarantine"):
        QuarantineStore(path).add("c", "h", reason="x")
    with pytest.raises(json.JSONDecodeError):
        json.loads(path.read_text())                   # really torn
    q2 = QuarantineStore(path)
    assert not q2.is_quarantined("c", "h")
    assert q2.stats.corrupt_recoveries == 1
    assert path.with_suffix(".json.corrupt").exists()
    q2.add("c", "h2", reason="y")                      # writable again
    assert QuarantineStore(path).is_quarantined("c", "h2")


def test_autotune_cache_torn_write_recovery(problem):
    from repro_torch.core.autotune import AutotuneCache

    path = os.environ["LILAC_TORCH_AUTOTUNE_CACHE"]
    with faults.inject("cache_torn_write:autotune"):
        fast = lilac.compile(naive_spmv, mode="host", policy="autotune",
                             platform="cpu")
        _assert_oracle(fast(*_args(problem)), problem)
    assert os.path.exists(path)
    store = AutotuneCache(path, registry_fingerprint="")
    store.load()
    assert store.stats.corrupt_recoveries == 1
    assert os.path.exists(path + ".corrupt")


def test_plan_cache_torn_write_recovery(problem):
    from repro_torch.core.plan import PlanCache

    path = os.environ["LILAC_TORCH_PLAN_CACHE"]
    with faults.inject("cache_torn_write:plans"):
        fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
        _assert_oracle(fast(*_args(problem)), problem)
    assert os.path.exists(path)
    store = PlanCache(path, registry_fingerprint="")
    store.load()
    assert store.stats.corrupt_recoveries == 1


# ---------------------------------------------------------------------------
# shadow verification
# ---------------------------------------------------------------------------

def test_outputs_close():
    a = torch.arange(4.0)
    assert outputs_close(a, a + 1e-7)
    assert not outputs_close(a, a + 1.0)
    assert not outputs_close((a, a), (a,))
    bad = a.clone()
    bad[1] = float("nan")
    assert not outputs_close(bad, a)          # NaN only in the accelerated
    assert outputs_close(bad, bad)            # NaN in the reference too
    assert outputs_close(torch.tensor([1, 2]), torch.tensor([1, 2]))
    assert not outputs_close(torch.tensor([1, 2]), torch.tensor([1, 3]))
    assert outputs_close(np.arange(4.0), np.arange(4.0))
    # bf16: relative L2 <= 2e-2, not elementwise
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    noisy = (w * (1 + 5e-3 * torch.from_numpy(
        rng.standard_normal(4096).astype(np.float32)))).bfloat16()
    assert outputs_close(noisy, w.bfloat16())
    assert not outputs_close(noisy.float(), w)      # f32 keeps 1e-4
    assert not outputs_close((w * 1.05).bfloat16(), w.bfloat16())


def test_shadow_rate_zero_never_checks(problem):
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    for _ in range(4):
        fast(*_args(problem))
    info = fast.resilience_info()
    assert info["shadow_rate"] == 0.0
    assert info["containment"]["shadow_checks"] == 0


def test_shadow_sampling_rate(problem, monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "0.25")
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    fast(*_args(problem))                     # cold call bakes
    for _ in range(8):                        # 8 plan calls
        _assert_oracle(fast(*_args(problem)), problem)
    assert fast.resilience_info()["containment"]["shadow_checks"] == 2


def _drifting(fast, monkeypatch):
    sane = fast._dispatch_plan
    monkeypatch.setattr(fast, "_dispatch_plan",
                        lambda plan, tensors: sane(plan, tensors) + 1.0)
    return sane


def test_shadow_divergence_quarantines_and_retunes(problem, monkeypatch):
    """A plan whose output drifts is caught by the shadow, its selection
    quarantined and the plan torn down: the drifted answer is never
    served, and the next call re-selects and stays correct."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1.0")
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    _assert_oracle(fast(*_args(problem)), problem)     # bake
    first = fast.last_selections[0][1]
    sane = _drifting(fast, monkeypatch)
    _assert_oracle(fast(*_args(problem)), problem)     # caught here
    info = fast.resilience_info()
    assert info["containment"]["shadow_divergences"] == 1
    assert info["quarantine_active"] >= 1
    assert fast.plan_info()["baked"] == 0
    monkeypatch.setattr(fast, "_dispatch_plan", sane)
    _assert_oracle(fast(*_args(problem)), problem)     # re-selected
    assert fast.last_selections[0][1] != first
    assert fast.resilience_info()["containment"]["shadow_divergences"] == 1


def test_shadow_rate_spikes_on_divergence_then_decays(problem, monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1.0")
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    _assert_oracle(fast(*_args(problem)), problem)
    sane = _drifting(fast, monkeypatch)
    _assert_oracle(fast(*_args(problem)), problem)     # divergence caught
    shadow = fast.resilience_info()["shadow"]
    assert shadow["multiplier"] >= 8.0
    assert shadow["peak_multiplier"] >= 8.0
    assert shadow["incidents"] >= 1
    monkeypatch.setattr(fast, "_dispatch_plan", sane)
    for _ in range(8):                                 # clean streak
        _assert_oracle(fast(*_args(problem)), problem)
    shadow = fast.resilience_info()["shadow"]
    assert shadow["multiplier"] < 2.0
    assert shadow["peak_multiplier"] >= 8.0
    assert shadow["floor"] == 1.0


def test_shadow_rate_spikes_on_quarantine(problem, monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "0.05")
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    with faults.inject("kernel_raise"):
        _assert_oracle(fast(*_args(problem)), problem)
    info = fast.resilience_info()
    assert info["containment"]["quarantines"] >= 1
    assert info["shadow"]["multiplier"] >= 8.0
    assert info["shadow_rate"] == pytest.approx(
        min(1.0, 0.05 * info["shadow"]["multiplier"]))


def test_report_divergence_quarantines_and_retunes(problem):
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    _assert_oracle(fast(*_args(problem)), problem)
    assert fast._last_plan is not None
    fast.report_divergence(reason="request-shadow divergence (rid 7)")
    assert fast._last_plan is None
    info = fast.resilience_info()
    assert info["containment"]["shadow_divergences"] == 1
    assert info["quarantine_active"] >= 1
    assert info["shadow"]["multiplier"] >= 8.0
    _assert_oracle(fast(*_args(problem)), problem)


# ---------------------------------------------------------------------------
# what the card adds, and the rest of the port's surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error,code", [
    (RuntimeError("spmv_ell launch failed: cudaError 700"), 700),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     700),
    (RuntimeError("CUDA error: device-side assert triggered"), 710),
    (RuntimeError("CUDA error: unspecified launch failure"), 719),
    (RuntimeError("CUDA error: misaligned address"), 716),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), None),
    (RuntimeError("spmv_ell launch failed: cudaError 9"), None),
    (RuntimeError("spmv_ell launch failed: cudaError 701"), None),
    (RuntimeError("CUDA error: invalid argument"), None),
    (ValueError("rows_per_slab must divide"), None),
])
def test_sticky_errors_are_classified(error, code):
    assert R.sticky_error_code(error) == code
    wrapped = RuntimeError("candidate failed")
    wrapped.__cause__ = error
    assert R.sticky_error_code(wrapped) == code


def _one_match(problem):
    from repro_torch.core import detect as TD

    gm = TD.trace(naive_spmv, list(_args(problem)))
    (m,) = TD.Detector().detect(gm).matches
    return m


@pytest.mark.parametrize("message,sticky", [
    ("launch failed: cudaError 700", True),
    ("launch failed: cudaError 2", False),
])
def test_a_sticky_error_is_recorded_then_raised(problem, tmp_path, message,
                                                sticky):
    """On the card, an error that poisons the CUDA context cannot be
    contained in-process: the quarantine record reaches the disk first,
    then one error names the harness and asks for a restart.  An error
    that leaves the context usable (out of memory) is contained."""
    from repro_torch.core.harness import CallCtx

    m = _one_match(problem)
    path = tmp_path / "sticky.json"
    store = QuarantineStore(path)
    contain = R.Containment(REGISTRY, store)
    ctx = CallCtx(mode="host", cache=None, format="CSR", platform="cuda")
    first = REGISTRY.get("spmv_csr", "torch.segment")

    def attempt(h, c):
        if h is first:
            raise RuntimeError(message)
        return torch.zeros(ROWS)

    run = lambda: contain(m, {}, ctx, lambda *a: first, attempt)  # noqa: E731
    if sticky:
        with pytest.raises(R.StickyDeviceFault,
                           match="torch.segment.*restart") as ei:
            run()
        assert ei.value.code == 700 and contain.stats.sticky_faults == 1
        rec = QuarantineStore(path).active()     # a fresh process's view
        assert list(rec) == ["spmv_csr|torch.segment|default"]
        assert "cudaError 700" in rec["spmv_csr|torch.segment|default"][
            "reason"]
    else:
        with pytest.warns(LilacContainmentWarning):
            out = run()
        assert out.shape == (ROWS,) and contain.stats.sticky_faults == 0
        assert contain.stats.contained_exceptions == 1


def test_the_validator_never_swallows_a_fault_of_the_card(problem,
                                                          monkeypatch):
    """An asynchronous fault surfaces at the validator's own sync: it is
    a failed attempt, not a healthy call (here the error is no sticky one
    and is contained)."""
    from repro_torch.core.harness import CallCtx

    m = _one_match(problem)
    contain = R.Containment(REGISTRY, shared_quarantine())
    ctx = CallCtx(mode="host", cache=None, format="CSR", platform="cpu")
    first = REGISTRY.get("spmv_csr", "torch.segment")
    real = torch.isfinite
    seen = []

    def isfinite(t):
        seen.append(1)
        if len(seen) == 1:
            raise RuntimeError("CUDA error: out of memory")
        return real(t)

    monkeypatch.setattr(torch, "isfinite", isfinite)
    with pytest.warns(LilacContainmentWarning, match="out of memory"):
        contain(m, {}, ctx, lambda *a: first,
                lambda h, c: torch.ones(ROWS))
    assert contain.stats.contained_exceptions == 1 and len(seen) == 2


def test_validator_and_corrupt_pass_traced_values_through():
    """Under ``make_fx`` a harness output is a fake (or functional)
    tensor: ``corrupt`` leaves it alone and the validator checks its size
    only, never its values."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize

    contain = R.Containment(REGISTRY, shared_quarantine())
    like = torch.zeros(4)
    seen = {}

    def fn(x):
        with faults.inject("nan_output:*") as plan:
            y = faults.corrupt("nan_output", "toy", x * 2)
        seen["fired"] = list(plan.fired)
        seen["verdict"] = contain._validate(y, like)
        seen["wrong_size"] = contain._validate(y[:2], like)
        return y

    gm = make_fx(functionalize(fn), tracing_mode="fake")(torch.ones(4))
    assert seen["fired"] == [] and seen["verdict"] is None
    assert seen["wrong_size"].startswith("shape mismatch")
    assert not any("nan" in str(n.args) for n in gm.graph.nodes)
    with faults.inject("nan_output:*"):
        out = faults.corrupt("nan_output", "toy", torch.ones(4))
    assert torch.isnan(out).all()


def test_nan_output_in_trace_mode_never_reaches_the_graph(problem):
    with faults.inject("nan_output:*"):
        fast = lilac.compile(naive_spmv, platform="cpu")
        _assert_oracle(fast(*_args(problem)), problem)
        _assert_oracle(fast(*_args(problem)), problem)


def test_a_plan_call_runs_no_finiteness_check_and_no_sync(problem,
                                                          monkeypatch):
    """The validator syncs, so it runs on the interpreter path only: a
    baked plan's call runs no ``isfinite`` and no ``.item()``, and with a
    chaos plan active its program still fires no fault."""
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    fast(*_args(problem))
    assert fast.plan_info()["baked"] == 1
    calls = []
    real_isfinite, real_item = torch.isfinite, torch.Tensor.item
    monkeypatch.setattr(torch, "isfinite",
                        lambda *a, **k: calls.append("isfinite")
                        or real_isfinite(*a, **k))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item") or real_item(self))
    with faults.inject("kernel_raise:*,nan_output:*") as plan:
        for _ in range(3):
            _assert_oracle(fast(*_args(problem)), problem)
    assert fast.plan_info()["plan_hits"] == 3
    assert plan.fired == []
    assert "isfinite" not in calls and "item" not in calls


def test_every_containment_event_is_loud(problem):
    """The warning names the computation, the harness, the variant and
    the reason; the event is counted and persisted."""
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    with faults.inject("kernel_raise:torch.segment"):
        with pytest.warns(LilacContainmentWarning) as rec:
            _assert_oracle(fast(*_args(problem)), problem)
    text = str(rec[0].message)
    for word in ("spmv_csr", "'torch.segment'", "variant default",
                 "InjectedFault"):
        assert word in text
    assert fast.resilience_info()["containment"]["quarantines"] == 1
    on_disk = QuarantineStore(os.environ["LILAC_TORCH_QUARANTINE_CACHE"])
    assert on_disk.is_quarantined("spmv_csr", "torch.segment")


def test_a_new_function_skips_a_quarantined_harness(problem):
    """A quarantine outlives the function that saw the fault: a new one
    selects the next candidate with no containment event, until the store
    is cleared, but never quietly: the skip warns and is counted."""
    _skips_loudly(problem, "default")


def test_a_named_policy_skips_a_quarantined_harness_loudly(problem):
    """The same under the quarantined harness's own name: the policy is
    not followed, and each selection says so."""
    _skips_loudly(problem, "torch.segment")


def _skips_loudly(problem, policy):
    fast = lilac.compile(naive_spmv, mode="host", policy=policy,
                         platform="cpu")
    with faults.inject("kernel_raise:torch.segment"):
        with pytest.warns(LilacContainmentWarning):
            fast(*_args(problem))
    fallback = fast.last_selections[0][1]
    assert fallback != "torch.segment"
    again = lilac.compile(naive_spmv, mode="host", policy=policy,
                          platform="cpu")
    with pytest.warns(LilacContainmentWarning,
                      match="'torch.segment' .*is quarantined") as rec:
        _assert_oracle(again(*_args(problem)), problem)
    assert len(rec) == 1 and f"'{fallback}' runs in its place" \
        in str(rec[0].message)
    assert again.last_selections[0][1] == fallback
    info = again.resilience_info()["containment"]
    assert info["quarantines"] == 0 and info["contained_exceptions"] == 0
    assert info["quarantine_skips"] == 1
    shared_quarantine().clear()
    third = lilac.compile(naive_spmv, mode="host", policy=policy,
                          platform="cpu")
    third(*_args(problem))
    assert third.last_selections[0][1] == "torch.segment"
    assert third.resilience_info()["containment"]["quarantine_skips"] == 0


def test_a_divergence_retires_the_persisted_plan(problem, monkeypatch):
    """The plan cache's record of a torn-down plan is retired: a fresh
    function on the same plan cache detects again instead of rehydrating
    the quarantined selection."""
    fast = lilac.compile(naive_spmv, mode="host", policy="autotune",
                         platform="cpu")
    fast(*_args(problem))
    fast.report_divergence("test")
    reset_shared_plan_caches()
    again = lilac.compile(naive_spmv, mode="host", policy="autotune",
                          platform="cpu")
    report = again.prewarm(_args(problem))
    assert report["detect_calls"] == 1 and report["plan_cache_hits"] == 0
    assert report["baked"] == 1
    _assert_oracle(again(*_args(problem)), problem)


def test_prewarm_from_shapes(problem):
    """``prewarm`` makes a (shape, dtype) leaf as zeros, bakes each
    signature and counts detection; a warm process detects nothing."""
    val, col, row_ptr, vec = _args(problem)
    sig = ((tuple(val.shape), torch.float32), col, row_ptr,
           ((COLS,), torch.float32))
    fast = lilac.compile(naive_spmv, mode="host", platform="cpu")
    rep = fast.prewarm(sig)
    assert rep["n_signatures"] == 1 and rep["baked"] == 1
    assert rep["detect_calls"] == 1
    reset_shared_plan_caches()
    warm = lilac.compile(naive_spmv, mode="host", platform="cpu").prewarm(sig)
    assert warm["detect_calls"] == 0 and warm["plan_cache_hits"] == 1


def test_prewarm_bakes_its_zeros_as_static_leaves(problem, monkeypatch):
    """The plan ``prewarm`` bakes is told which flat leaves are its own
    zeros (a CUDA graph captures static buffers there from the start); a
    bake on a caller's call is told none."""
    from repro_torch.core import plan as P

    seen, finish = [], P._finish

    def recording(plan, tensors, static_leaves):
        seen.append(static_leaves)
        return finish(plan, tensors, static_leaves)

    monkeypatch.setattr(P, "_finish", recording)
    val, col, row_ptr, vec = _args(problem)
    sig = ((tuple(val.shape), torch.float32), col, row_ptr,
           ((COLS,), torch.float32))
    rep = lilac.compile(naive_spmv, mode="host", platform="cpu",
                        plan_cache="off").prewarm(sig)
    assert rep["baked"] == 1
    lilac.compile(naive_spmv, mode="host", platform="cpu",
                  plan_cache="off")(*_args(problem))
    assert seen == [frozenset({0, 3}), frozenset()]


def cg_step(m, p, r):
    ap = m @ p
    return torch.dot(r, r) / (p * ap).sum(), ap


def test_dot_and_gemv_under_kernel_raise_torch_dot():
    """torch.dot is the only harness of the dot and GEMV matches: with
    it failing, every match falls back to its plain node and the step
    still returns the program's value."""
    rng = np.random.default_rng(8)
    m = torch.from_numpy(rng.standard_normal((COLS, COLS)).astype(np.float32))
    p, r = (torch.from_numpy(rng.standard_normal(COLS).astype(np.float32))
            for _ in range(2))
    fast = lilac.compile(cg_step, mode="host", platform="cpu")
    with faults.inject("kernel_raise:torch.dot"):
        with pytest.warns(LilacContainmentWarning):
            got = fast(m, p, r)
    assert sorted(mm.computation for mm in fast.last_report.matches) \
        == ["dotproduct", "dotproduct", "gemv"]
    info = fast.resilience_info()
    assert info["disabled_matches"] == 3
    assert info["containment"]["fallbacks"] == 3
    for a, b in zip(got, cg_step(m, p, r)):
        torch.testing.assert_close(a, b)
    assert fast.last_selections == []


def test_a_named_policy_leaves_dot_on_torch_dot(problem):
    """``policy="torch.ell"`` names an SpMV harness: the dot products of
    the same program stay on their default, torch.dot."""
    def step(val, col, row_ptr, vec):
        q = naive_spmv(val, col, row_ptr, vec)
        return torch.dot(q, q), q

    fast = lilac.compile(step, mode="host", policy="torch.ell",
                         platform="cpu")
    got = fast(*_args(problem))
    assert sorted((mm.computation, n) for mm, n in fast.last_selections) \
        == [("dotproduct", "torch.dot"), ("spmv_csr", "torch.ell")]
    torch.testing.assert_close(got[0], step(*_args(problem))[0],
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(KeyError):
        lilac.compile(step, mode="host", policy="no.such.harness",
                      platform="cpu")(*_args(problem))


@pytest.mark.parametrize("comp,fmt,policy,want", [
    ("spmv_csr", "CSR", "cuda.gmm", KeyError),
    ("spmm_csr", "CSR", "cuda.ell", KeyError),
    ("moe_ffn", "MOE", "cuda.ell", KeyError),
    ("dotproduct", "", "cuda.ell", "torch.dot"),
    ("gemv", "", "cuda.bcsr", "torch.dot"),
    ("dotproduct", "", "no.such.harness", KeyError),
])
def test_a_named_policy_of_another_computation(comp, fmt, policy, want):
    """A policy naming another computation's harness leaves only a
    computation without a hand-written kernel (dot, GEMV) on its default;
    one that has a kernel raises, as the reference does, so a mis-pinned
    policy never runs the plain version unannounced."""
    if want is KeyError:
        with pytest.raises(KeyError):
            REGISTRY.select(comp, fmt, "cpu", "host", policy=policy)
    else:
        assert REGISTRY.select(comp, fmt, "cpu", "host",
                               policy=policy).name == want


class _Cand:
    def __init__(self, name):
        self.name = name


class _Registry:
    """Two candidates of one computation, the kernel first."""

    def __init__(self, names):
        self.cands = [_Cand(n) for n in names]

    def candidates(self, comp, fmt, platform, mode):
        return self.cands

    def default_name(self, comp, platform):
        return self.cands[0].name


def _match():
    from types import SimpleNamespace

    return SimpleNamespace(computation="spmv_csr", format="CSR",
                           anchor=SimpleNamespace(
                               meta={"val": torch.zeros(4)}))


@pytest.mark.parametrize("platform,harness,error,contained", [
    ("cuda", "cuda.ell", RuntimeError("nvcc failed"), False),
    ("cuda", "cuda.ell", RuntimeError("launch failed: cudaError 9"), False),
    ("cuda", "cuda.ell", faults.InjectedFault("kernel_raise", "cuda.ell"),
     True),
    ("cuda", "cuda.ell", torch.cuda.OutOfMemoryError("out of memory"), True),
    ("cuda", "torch.ell", RuntimeError("shape"), True),
    ("cpu", "cuda.ell", RuntimeError("nvcc failed"), True),
])
def test_a_kernel_of_the_port_that_breaks_on_the_card_raises(
        platform, harness, error, contained):
    """On the card a ``cuda.*`` harness's own exception (a kernel that
    does not build or launch) reaches the caller and quarantines nothing:
    running the plain version in its place would hide a broken port.  An
    injected fault, out of memory and a ``torch.*`` harness's error are
    contained: the next candidate answers, loudly."""
    from repro_torch.core.harness import CallCtx

    reg = _Registry([harness, "torch.segment"])
    q = shared_quarantine()
    stats = R.ContainmentStats()
    contain = R.Containment(reg, q, stats=stats)
    ctx = CallCtx(mode="host", cache=None, format="CSR", platform=platform)

    def attempt(h, c):
        if h.name == harness:
            raise error
        return torch.ones(4)

    def run():
        return contain(_match(), {}, ctx, lambda m, b, c: reg.cands[0],
                       attempt)

    if contained:
        with pytest.warns(LilacContainmentWarning, match=repr(harness)):
            assert torch.equal(run(), torch.ones(4))
        assert q.is_quarantined("spmv_csr", harness)
        assert stats.contained_exceptions == 1
    else:
        with pytest.raises(type(error), match=str(error)):
            run()
        assert not q.active() and stats.as_dict() == \
            R.ContainmentStats().as_dict()


def test_a_broken_kernel_candidate_on_the_card_raises_through_the_race():
    """The tuner's :class:`CandidateFailure` for a ``cuda.*`` candidate on
    the card propagates through containment's race (PR 15's rule: a broken
    kernel never loses quietly to a ``torch.*`` one); a ``torch.*``
    candidate's is contained and the race runs again without it."""
    from repro_torch.core.autotune import CandidateFailure
    from repro_torch.core.harness import CallCtx

    reg = _Registry(["cuda.ell", "torch.segment"])
    q = shared_quarantine()
    contain = R.Containment(reg, q)
    ctx = CallCtx(mode="host", cache=None, format="CSR", platform="cuda")

    def race(broken):
        def select(m, b, c):
            if not q.is_quarantined("spmv_csr", broken):
                raise CandidateFailure(broken, None, None,
                                       RuntimeError("nvcc failed"))
            return reg.cands[1]
        return select

    with pytest.raises(CandidateFailure, match="cuda.ell"):
        contain.pick(_match(), {}, ctx, race("cuda.ell"))
    assert not q.active()
    with pytest.warns(LilacContainmentWarning, match="'torch.ell'"):
        got = contain.pick(_match(), {}, ctx, race("torch.ell"))
    assert got.name == "torch.segment"
    assert q.is_quarantined("spmv_csr", "torch.ell")


def test_a_broken_candidate_in_trace_mode_is_contained(problem, monkeypatch):
    """Trace mode selects while it builds the graph: a candidate that
    breaks the tuner's race there is quarantined too, and the graph is
    built on another harness."""
    h = REGISTRY.get("spmv_ell", "torch.ell")

    def broken(b, ctx):
        raise RuntimeError("launch failed: cudaError 9")

    monkeypatch.setattr(h, "fn", broken)
    rng = np.random.default_rng(11)
    val = torch.from_numpy(rng.standard_normal((ROWS, 8)).astype(np.float32))
    col = torch.from_numpy(rng.integers(0, COLS, (ROWS, 8)).astype(np.int64))
    vec = torch.from_numpy(rng.standard_normal(COLS).astype(np.float32))

    def ell(val, col, vec):
        return (val * vec[col]).sum(dim=1)

    fast = lilac.compile(ell, policy="autotune", platform="cpu")
    with pytest.warns(LilacContainmentWarning, match="cudaError 9"):
        out = fast(val, col, vec)
    torch.testing.assert_close(out, ell(val, col, vec))
    assert shared_quarantine().is_quarantined("spmv_ell", "torch.ell")
    assert [n for _, n in fast.last_selections] != ["torch.ell"]
    assert fast.resilience_info()["tuner_quarantine_skips"] >= 1
