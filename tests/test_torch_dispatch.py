"""The port's executable plans and plan cache (repro_torch.core.plan), on
the contract of tests/test_dispatch.py and docs/dispatch.md:

  * a resolved rewrite bakes into an ExecutablePlan and repeat calls take
    the guard-check fast path; baked and interpreted dispatch give the
    same bits
  * guards: a new vector keeps the fast path (it is data, not a marshal
    source); a TrackedArray replace, an in-place edit of the matrix (one
    element off the fingerprint's sample grid included) and an edit of a
    borrowed closure capture bust it; a content-identical re-upload moves
    the guards without a re-bake
  * what never bakes: marshal-bearing selections under
    marshal_policy="off", a harness that opts out, a borrowed capture past
    the exact-guard bound; a harness override refuses a plan
  * matches serialize; the plan cache round-trips, drops on a registry or
    schema change, degrades to detection on a corrupt or stale record, and
    serves a second process with zero detection calls
  * the JAX package's plan life cycle: the same counts on one call
    sequence, outputs within the slice's tolerance

Runs on the CPU: the plan runs its program eagerly here (the CUDA-graph
replay is tests/test_torch_kernels_gpu.py's).  Each test gets its own
plan cache and tuner store.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import detect as D
from repro_torch.core import plan as P
from repro_torch.core.harness import REGISTRY
from repro_torch.core.marshal import TrackedArray, version_token
from repro_torch.sparse import formats as tf
from repro_torch.sparse import random as trandom
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = dict(atol=1e-4, rtol=1e-4)


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
    monkeypatch.delenv("LILAC_TORCH_PLAN_CACHE_DISABLE", raising=False)
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()
    yield
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def _problem(n=96, density=0.1, seed=0):
    ref = random_csr(n, n, density=density, seed=seed, skew=1.0)
    v = np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32)
    return ref, tf.from_numpy(ref), torch.from_numpy(v)


def _args(csr, v):
    return (csr.val, csr.col_ind, csr.row_ptr, v)


def _host(policy="torch.ell", **kw):
    return lilac.compile(naive, mode="host", policy=policy, platform="cpu",
                         **kw)


class _DetectSpy:
    """Counts ``Detector.detect`` calls while active."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = D.Detector.detect

        def spy(det, gm):
            self.n += 1
            return orig(det, gm)

        monkeypatch.setattr(D.Detector, "detect", spy)


# ---------------------------------------------------------------------------
# baking and the fast path
# ---------------------------------------------------------------------------

def test_bakes_plan_and_hits_fast_path():
    _, csr, v = _problem()
    fast = _host()
    a = _args(csr, v)
    out1 = fast(*a)                     # interpreted, recorded, baked
    info = fast.plan_info()
    assert info["baked"] == 1 and not info["bake_errors"]
    out2 = fast(*a)                     # the plan
    assert fast.plan_info()["plan_hits"] == 1
    out3 = fast(*a)
    assert fast.plan_info()["plan_hits"] == 2
    assert fast.last_selections[0][1] == "torch.ell"
    assert torch.equal(out2, out1) and torch.equal(out3, out1)
    torch.testing.assert_close(out1, naive(*a), **TOL)
    plan = fast.executable_plan(*a)
    assert plan is not None and plan.describe()["guards"] == 3


def test_vector_churn_keeps_fast_path():
    """The vector is data, not a marshal source: new tensors every call
    keep the plan."""
    _, csr, _ = _problem()
    fast = _host()
    rng = np.random.default_rng(7)
    vecs = [torch.from_numpy(rng.standard_normal(96).astype(np.float32))
            for _ in range(4)]
    fast(*_args(csr, vecs[0]))
    for v in vecs[1:]:
        torch.testing.assert_close(fast(*_args(csr, v)),
                                   naive(*_args(csr, v)), **TOL)
    info = fast.plan_info()
    assert info["plan_hits"] == 3 and info["rebakes"] == 0


def test_no_match_program_bakes():
    def fn(x):
        return x * 2.0 + 1.0

    fast = lilac.compile(fn, mode="host", platform="cpu")
    x = torch.arange(8.0)
    out1 = fast(x)
    assert fast.plan_info()["baked"] == 1 and fast.last_selections == []
    out2 = fast(x)
    assert fast.plan_info()["plan_hits"] == 1
    assert torch.equal(out1, fn(x)) and torch.equal(out2, fn(x))


def test_bake_false_keeps_interpreter():
    _, csr, v = _problem()
    fast = _host(bake=False)
    for _ in range(3):
        fast(*_args(csr, v))
    info = fast.plan_info()
    assert info["baked"] == 0 and info["plan_hits"] == 0
    assert fast.cache.stats.hits == 2


def test_signature_change_uses_separate_plans():
    fast = lilac.compile(lambda x: x * 1.5 + 1.0, mode="host",
                         platform="cpu")
    x1, x2 = torch.arange(8.0), torch.arange(16.0)
    fast(x1), fast(x1)
    fast(x2), fast(x2)
    info = fast.plan_info()
    assert info["entries"] == 2 and info["baked"] == 2
    # alternating signatures: the hot plans serve each without re-keying
    assert torch.equal(fast(x1), x1 * 1.5 + 1.0)
    assert torch.equal(fast(x2), x2 * 1.5 + 1.0)
    assert fast.plan_info()["plan_hits"] == 4


@pytest.mark.parametrize("policy", ["torch.ell", "default"])
def test_baked_vs_interpreted_bit_identical(policy):
    _, csr, v = _problem(n=128, density=0.08, seed=42)
    a = _args(csr, v)
    interp = _host(policy, bake=False)
    baked = _host(policy)
    want = interp(*a)
    baked(*a)
    assert baked.plan_info()["baked"] == 1
    assert torch.equal(baked(*a), want)
    assert baked.plan_info()["plan_hits"] == 1


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_tracked_array_replace_busts_plan():
    _, csr, v = _problem()
    fast = _host()
    ta = TrackedArray(csr.val)
    fast(ta, csr.col_ind, csr.row_ptr, v)
    fast(ta, csr.col_ind, csr.row_ptr, v)
    assert fast.plan_info()["plan_hits"] == 1
    ta2 = ta.replace(csr.val * 2.0)
    assert version_token(ta2) != version_token(ta)
    out = fast(ta2, csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(
        out, naive(csr.val * 2.0, csr.col_ind, csr.row_ptr, v), **TOL)
    assert fast.plan_info()["rebakes"] == 1
    fast(ta2, csr.col_ind, csr.row_ptr, v)
    assert fast.plan_info()["plan_hits"] == 1     # the new plan's count


def test_write_through_data_declared_by_tracked_array_replace():
    """A write through ``.data`` moves no ``_version``: the caller declares
    it with ``TrackedArray.replace`` (same tensor), which every layer then
    sees."""
    csr = trandom.random_spd_csr(1000, 20, seed=3)
    v = torch.randn(1000)
    val = csr.val.clone()
    fast = _host()
    ta = TrackedArray(val)
    fast(ta, csr.col_ind, csr.row_ptr, v)
    fast(ta, csr.col_ind, csr.row_ptr, v)
    val.data[777] += 50.0                # invisible to _version
    out = fast(ta.replace(val), csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(out, naive(val, csr.col_ind, csr.row_ptr, v),
                               **TOL)


@pytest.mark.parametrize("bake", [True, False])
def test_inplace_single_element_edit_of_large_val_gives_naive_result(bake):
    """One element of a > 64 KB ``val`` (sampled by the fingerprint),
    off the sample grid, written in place between two calls: the data
    plane sees the tensor's new version and re-marshals, and the plan's
    version guard misses, so the output is the naive one."""
    csr = trandom.random_spd_csr(2000, 20, seed=1)
    v = torch.randn(2000)
    val = csr.val.clone()
    assert val.numel() * 4 > 1 << 16
    step = val.numel() // 1024
    i = 12345
    assert i % step and 64 <= i < val.numel() - 64     # off the sample
    fast = _host("torch.ell", bake=bake)
    fast(val, csr.col_ind, csr.row_ptr, v)
    fast(val, csr.col_ind, csr.row_ptr, v)
    val[i] += 100.0
    got = fast(val, csr.col_ind, csr.row_ptr, v)
    assert torch.equal(got, _host("torch.ell", bake=False)(
        val, csr.col_ind, csr.row_ptr, v))
    torch.testing.assert_close(got, naive(val, csr.col_ind, csr.row_ptr, v),
                               **TOL)
    assert fast.cache.stats.misses == 2 and fast.cache.stats.stale == 1
    assert fast.plan_info()["rebakes"] == (1 if bake else 0)


@pytest.mark.parametrize("bake", [True, False])
def test_inference_tensor_inplace_edit_gives_naive_result(bake):
    """A matrix made under torch.inference_mode has no version counter:
    the data plane keys it by its exact bytes and the plan guards it by
    its checksum, so an in-place edit under inference_mode between two
    calls still gives the naive result."""
    csr = trandom.random_spd_csr(2000, 20, seed=4)
    v = torch.randn(2000)
    with torch.inference_mode():
        val = csr.val.clone()
        fast = _host("torch.ell", bake=bake)
        fast(val, csr.col_ind, csr.row_ptr, v)
        fast(val, csr.col_ind, csr.row_ptr, v)
        assert fast.plan_info()["plan_hits"] == (1 if bake else 0)
        val.mul_(2)
        got = fast(val, csr.col_ind, csr.row_ptr, v)
        want = naive(val, csr.col_ind, csr.row_ptr, v)
        val[12345] += 100.0
        got2 = fast(val, csr.col_ind, csr.row_ptr, v)
        want2 = naive(val, csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got2, want2, **TOL)
    assert fast.cache.stats.misses == 3


@pytest.mark.parametrize("bake", [True, False])
def test_edited_reupload_off_the_sample_grid_gives_naive_result(bake):
    """A new tensor whose bytes differ from the cached matrix's in one
    element off the fingerprint's sample grid: its sample matches, but its
    checksum does not, so the data plane re-marshals instead of serving
    the old layout (and a plan re-bakes instead of re-anchoring)."""
    csr = trandom.random_spd_csr(2000, 20, seed=5)
    v = torch.randn(2000)
    i = 12345
    assert i % (csr.val.numel() // 1024) and 64 <= i < csr.val.numel() - 64
    fast = _host("torch.ell", bake=bake)
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    val2 = csr.val.clone()
    val2[i] += 100.0
    got = fast(val2, csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(got, naive(val2, csr.col_ind, csr.row_ptr, v),
                               **TOL)
    assert fast.cache.stats.misses == 2 and fast.cache.stats.stale == 1
    assert fast.plan_info()["rebakes"] == (1 if bake else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8])
def test_checksum_sees_every_one_element_edit(dtype):
    """Equal bytes give equal checksums; a change to any one element (odd
    byte lengths padded) changes it."""
    from repro_torch.core.marshal import checksum

    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, 100, (1001,), generator=g).to(dtype)
    base = checksum(t)
    assert checksum(t.clone()) == base
    for i in (0, 1, 500, 999, 1000):
        u = t.clone()
        u[i] += 1
        assert checksum(u) != base, i
    swapped = t.clone()
    swapped[[3, 4]] = swapped[[4, 3]]
    assert torch.equal(swapped, t) or checksum(swapped) != base


@pytest.mark.parametrize("n,i", [(8, 3), ((1 << 16) // 4 + 4096, 100)])
def test_numpy_capture_edit_busts_plan(n, i):
    """A closure-captured numpy array wrapped with torch.as_tensor is a
    borrowed constant the interpreter re-reads every call: an in-place
    edit, one element of a > 64 KB capture off the sample grid included,
    busts the plan through its exact guard."""
    bias = np.zeros(n, np.float32)

    def fn(x):
        return x * 2.0 + torch.as_tensor(bias)

    fast = lilac.compile(fn, mode="host", platform="cpu")
    x = torch.ones(n)
    out1 = fast(x)
    fast(x)
    assert fast.plan_info()["plan_hits"] == 1
    assert fast.plan_info()["plans"][0]["const_guards"] == 1
    bias[i] += 5.0
    out2 = fast(x)
    assert float(out2[i]) == float(out1[i]) + 5.0
    assert fast.plan_info()["rebakes"] == 1


def test_huge_borrowed_capture_refuses_to_bake():
    big = np.zeros(P.CONST_GUARD_MAX_BYTES // 4 + 1024, np.float32)

    def fn(x):
        return x + torch.as_tensor(big)[: x.shape[0]]

    fast = lilac.compile(fn, mode="host", platform="cpu")
    x = torch.ones(16)
    fast(x)
    fast(x)
    info = fast.plan_info()
    assert info["baked"] == 0 and info["no_bake"] == 1
    assert "exact-guard bound" in info["bake_errors"][0]
    big[3] = 7.0                                       # interpreter stays live
    assert float(fast(x)[3]) == 8.0


def test_content_identical_reupload_refreshes_guards_without_rebake():
    _, csr, v = _problem()
    fast = _host()
    fast(*_args(csr, v))
    val2 = csr.val.clone()                             # equal, new tensor
    fast(val2, csr.col_ind, csr.row_ptr, v)            # guard miss: refresh
    assert fast.plan_info()["rebakes"] == 0
    fast(val2, csr.col_ind, csr.row_ptr, v)
    assert fast.plan_info()["plan_hits"] == 1


def test_marshal_policy_off_never_bakes_marshal_harnesses():
    _, csr, v = _problem()
    a = _args(csr, v)
    fast = _host(marshal_policy="off")
    out = fast(*a)
    fast(*a)
    info = fast.plan_info()
    assert info["baked"] == 0 and info["no_bake"] == 1
    assert "repack" in info["bake_errors"][0]
    torch.testing.assert_close(out, naive(*a), **TOL)
    plain = _host("torch.segment", marshal_policy="off")
    plain(*a)
    assert plain.plan_info()["baked"] == 1


def test_harness_override_invalidates_plan():
    """A same-name body replaced with override=True moves the registry's
    epoch: the plan re-bakes with the new body."""
    import dataclasses

    _, csr, v = _problem()
    a = _args(csr, v)
    fast = _host("torch.segment")
    out1 = fast(*a)
    fast(*a)
    assert fast.plan_info()["plan_hits"] == 1
    orig = REGISTRY.get("spmv_csr", "torch.segment")
    doubled = dataclasses.replace(orig,
                                  fn=lambda b, ctx: orig.fn(b, ctx) * 2.0)
    REGISTRY.register(doubled, override=True)
    try:
        out2 = fast(*a)
        torch.testing.assert_close(out2, out1 * 2.0)
        assert torch.equal(fast(*a), out2)
        assert fast.plan_info()["rebakes"] == 1
    finally:
        REGISTRY.register(orig, override=True)


def test_stateful_or_opted_out_harness_never_bakes():
    h = REGISTRY.get("spmv_csr", "torch.segment")
    orig = h.bakeable
    h.bakeable = False
    try:
        _, csr, v = _problem()
        fast = _host("torch.segment")
        fast(*_args(csr, v))
        fast(*_args(csr, v))
        info = fast.plan_info()
        assert info["baked"] == 0 and info["no_bake"] == 1
        assert "opted out" in info["bake_errors"][0]
    finally:
        h.bakeable = orig


def test_grad_and_subclass_leaves_never_hit_a_plan():
    fast = lilac.compile(lambda x: x * 3.0, mode="host", platform="cpu")
    x = torch.arange(4.0)
    fast(x)
    fast(x)
    assert fast.plan_info()["plan_hits"] == 1
    xg = torch.arange(4.0, requires_grad=True)
    out = fast(xg)
    assert fast.plan_info()["plan_hits"] == 1 and out.requires_grad


# ---------------------------------------------------------------------------
# serialization and the persistent plan cache
# ---------------------------------------------------------------------------

def test_match_serialization_round_trip():
    _, csr, v = _problem()
    fast = _host()
    fast(*_args(csr, v))
    entry = next(iter(fast._compiled.values()))
    ser = P.serialize_matches(entry.gm, entry.report.matches)
    assert json.loads(json.dumps(ser)) == ser
    got = P.rehydrate_matches(entry.gm, ser)
    assert got is not None and len(got) == len(entry.report.matches)
    for a, b in zip(entry.report.matches, got):
        assert (a.computation, a.variant, a.format, a.epilogue) == \
               (b.computation, b.variant, b.format, b.epilogue)
        assert a.anchor is b.anchor and a.claimed == b.claimed
        assert a.binding == b.binding


def test_plan_cache_round_trip_skips_detection(tmp_path, monkeypatch):
    _, csr, v = _problem()
    a = _args(csr, v)
    path = tmp_path / "mine.json"
    fast = _host("autotune", plan_cache=str(path))
    fast(*a)
    doc = json.loads(path.read_text())
    assert doc["schema"] == P.SCHEMA_VERSION
    (rec,) = doc["entries"].values()
    assert rec["pins"] and rec["matches"] and rec["detect_digest"]
    spy = _DetectSpy(monkeypatch)
    timed = REGISTRY.autotuner.stats.timing_calls
    again = _host("autotune", plan_cache=str(path))
    out = again(*a)
    assert spy.n == 0
    assert REGISTRY.autotuner.stats.timing_calls == timed
    assert again.plan_info()["baked"] == 1
    assert again.last_selections[0][1] == fast.last_selections[0][1]
    assert "rehydrated" in again.last_report.log[0]
    torch.testing.assert_close(out, naive(*a), **TOL)


@pytest.mark.parametrize("drift", ["registry", "schema"])
def test_plan_cache_invalidation(tmp_path, drift):
    path = tmp_path / "plans.json"
    c1 = P.PlanCache(path, registry_fingerprint="fp-A")
    c1.put("some|key", {"matches": [], "pins": {}})
    if drift == "registry":
        c2 = P.PlanCache(path, registry_fingerprint="fp-B")
    else:
        doc = json.loads(path.read_text())
        doc["schema"] = 99
        path.write_text(json.dumps(doc))
        c2 = P.PlanCache(path, registry_fingerprint="fp-A")
    assert c2.get("some|key") is None
    assert c2.stats.invalidations == 1


@pytest.mark.parametrize("damage", ["anchor", "digest"])
def test_corrupt_or_stale_record_degrades_to_detection(tmp_path, damage,
                                                       monkeypatch):
    """A record whose anchor no longer lines up, or whose digest is
    missing, is rejected and detection runs: never a wrong rewrite."""
    _, csr, v = _problem()
    a = _args(csr, v)
    path = tmp_path / "plans.json"
    _host(plan_cache=str(path))(*a)
    doc = json.loads(path.read_text())
    for rec in doc["entries"].values():
        if damage == "anchor":
            for m in rec["matches"]:
                m["anchor"] = 99999
            rec["detect_digest"] = P.detect_digest(rec["matches"])
        else:
            del rec["detect_digest"]
    path.write_text(json.dumps(doc))
    fresh = P.PlanCache(path, registry_fingerprint=REGISTRY.fingerprint())
    spy = _DetectSpy(monkeypatch)
    out = _host(plan_cache=fresh)(*a)
    assert fresh.stats.rejected == 1 and spy.n == 1
    torch.testing.assert_close(out, naive(*a), **TOL)


_SUBPROC = textwrap.dedent("""
    import json
    import numpy as np, torch
    from repro_torch import lilac
    from repro_torch.core import detect as D
    from repro_torch.core.harness import REGISTRY
    from repro_torch.sparse import random as trandom

    csr = trandom.random_spd_csr(300, 9, seed=2)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(300)
                         .astype(np.float32))
    calls = {"n": 0}
    orig = D.Detector.detect

    def spy(det, gm):
        calls["n"] += 1
        return orig(det, gm)

    D.Detector.detect = spy

    def naive(val, col, row_ptr, v):
        rows = row_ptr.shape[0] - 1
        row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                      output_size=val.shape[0])
        return torch.zeros(rows).index_add_(0, row, val * v[col])

    fast = lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu")
    out = fast(csr.val, csr.col_ind, csr.row_ptr, v)
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    print(json.dumps({"selected": fast.last_selections[0][1],
                      "detect_calls": calls["n"], "plan": fast.plan_info(),
                      "timing_calls": REGISTRY.autotuner.stats.timing_calls,
                      "out": out.tolist()}))
""")


def test_cross_process_warm_start_zero_detect(tmp_path):
    """A second process on the same plans.json (and a fresh tuner store)
    rehydrates matches and pins: zero detection calls, zero timing, the
    same selection, a baked plan."""
    env = dict(os.environ,
               LILAC_TORCH_PLAN_CACHE=str(tmp_path / "plans.json"),
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))

    def run(store):
        p = subprocess.run(
            [sys.executable, "-c", _SUBPROC],
            env=dict(env, LILAC_TORCH_AUTOTUNE_CACHE=str(tmp_path / store)),
            capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        return json.loads(p.stdout.strip().splitlines()[-1])

    first = run("at1.json")
    assert first["detect_calls"] == 1 and first["timing_calls"] > 0
    assert first["plan"]["baked"] == 1
    warm = run("at2.json")
    assert warm["detect_calls"] == 0 and warm["timing_calls"] == 0
    assert warm["selected"] == first["selected"]
    assert warm["plan"]["baked"] == 1 and warm["plan"]["plan_hits"] == 1
    assert warm["out"] == first["out"]


# ---------------------------------------------------------------------------
# against the JAX package's plan life cycle
# ---------------------------------------------------------------------------

def test_plan_life_cycle_matches_the_reference():
    """The same call sequence through the reference (``jnp.ell``) and the
    port (``torch.ell``): bake, hits, a new vector, a matrix update (a
    TrackedArray replace), hits again — the same plan counts, outputs
    within the slice's tolerance."""
    ref, csr, v = _problem(n=120, density=0.07, seed=11)
    rows, nnz = ref.rows, ref.nnz

    def naive_jax(val, col, row_ptr, x):
        row = jnp.repeat(jnp.arange(rows, dtype=jnp.int32),
                         jnp.diff(row_ptr), total_repeat_length=nnz)
        return jax.ops.segment_sum(val * x[col], row, num_segments=rows)

    jfast = jlilac.compile(naive_jax, mode="host", policy="jnp.ell")
    fast = _host()
    from repro.core.marshal import TrackedArray as JTracked

    v2 = np.random.default_rng(5).standard_normal(120).astype(np.float32)
    seq = [(1.0, v.numpy()), (1.0, v.numpy()), (1.0, v2), (3.0, v2),
           (3.0, v2), (3.0, v.numpy())]
    jta, ta = JTracked(jnp.asarray(ref.val)), TrackedArray(csr.val)
    scale = 1.0
    for k, (s, x) in enumerate(seq):
        if s != scale:
            jta = jta.replace(jnp.asarray(ref.val) * s)
            ta = ta.replace(csr.val * s)
            scale = s
        want = np.asarray(jfast(jta, jnp.asarray(ref.col_ind),
                                jnp.asarray(ref.row_ptr), jnp.asarray(x)))
        got = fast(ta, csr.col_ind, csr.row_ptr, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        ji, ti = jfast.plan_info(), fast.plan_info()
        assert (ti["baked"], ti["plan_hits"], ti["rebakes"]) == \
            (ji["baked"], ji["plan_hits"], ji["rebakes"]), (k, ji, ti)
    assert fast.plan_info()["rebakes"] == 1
