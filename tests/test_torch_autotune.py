"""The port's persistent autotuner and its store against the JAX package's:
signature buckets, operand synthesis, the schema-4 JSON store (round
trip, concurrent writers, invalidation), the budget, successive halving,
stale records, the repack-amortized rule, tune clauses reaching the body,
and host-mode ``policy="autotune"`` end to end — warm in process and in a
fresh subprocess with zero candidates re-timed.

Each test gets its own store: the autouse fixture points
``LILAC_TORCH_AUTOTUNE_CACHE`` into ``tmp_path`` (tests/conftest.py
isolates only the JAX package's ``LILAC_*`` files) and turns the plan
cache off, so that a warm process asks the tuner's store.  Timing runs here on
the CPU, so where a winner matters the timer is rigged; no test asserts
which real harness is fastest.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import lilac as jlilac
from repro.core import autotune as jautotune
from repro.sparse import random_csr
from repro_torch import lilac
from repro_torch.core import autotune as A
from repro_torch.core.harness import REGISTRY, CallCtx, Harness, HarnessRegistry
from repro_torch.core.marshal import DataPlane, MarshalPolicy
from repro_torch.sparse import formats as tf
from repro_torch.core import faults
from repro_torch.core.resilience import (LilacContainmentWarning,
                                         reset_shared_quarantine,
                                         shared_quarantine)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ROWS, COLS = 96, 80
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
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
    # these tests hold the tuner's own store: a plan cache would serve the
    # pins of a warm process before the tuner is asked
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE_DISABLE", "1")
    for k in ("LILAC_TORCH_AUTOTUNE_BUDGET", "LILAC_TORCH_AUTOTUNE_DISABLE",
              "LILAC_TORCH_AUTOTUNE_MAX_VARIANTS"):
        monkeypatch.delenv(k, raising=False)
    REGISTRY.reset_autotuner()
    yield
    REGISTRY.reset_autotuner()


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def naive_jax(val, col, row_ptr, v):
    import jax

    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def _operands():
    ref = random_csr(ROWS, COLS, density=0.08, seed=5, skew=1.0)
    v = np.random.default_rng(2).standard_normal(COLS).astype(np.float32)
    return ref, tf.from_numpy(ref), v


def _np_binding(rows=64, nnz=512, cols=64):
    return {"a": np.ones(nnz, np.float32),
            "colidx": np.zeros(nnz, np.int32),
            "rowstr": np.linspace(0, nnz, rows + 1).astype(np.int32),
            "iv": np.ones(cols, np.float32),
            "rows": rows, "nnz": nnz}


def _torch_binding(b):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in b.items()}


def _body(b, ctx, **schedule):
    return torch.zeros(b["rows"])


def _toy_registry(names, tune=None):
    """A registry of spmv_csr harnesses that do nothing; ``tune`` is the
    text of one harness's tune clauses."""
    reg = HarnessRegistry()
    for name in names:
        clauses = tune if (tune and name == names[0]) else ""
        lilac.register_spec(f"""
HARNESS {name} implements spmv_csr
  formats CSR;
{clauses}
""", {name: _body}, registry=reg)
    reg._defaults[("spmv_csr", "cpu")] = names[-1]
    return reg


def _ctx(cache=None, epilogue=None):
    return CallCtx(mode="host", cache=cache if cache is not None
                   else DataPlane(), format="CSR", platform="cpu",
                   epilogue=epilogue)


def _rig(monkeypatch, costs):
    """Make the tuner read variant seconds from ``costs[(harness,
    schedule_key)]`` (None: the variant raises); returns the call log."""
    calls = []

    def fake(self, h, binding, ctx, mode, operands, schedule, reps):
        calls.append((h.name, A.schedule_key(schedule), reps))
        return costs[(h.name, A.schedule_key(schedule))]

    monkeypatch.setattr(A.Autotuner, "_time_variant", fake)
    return calls


# ---------------------------------------------------------------------------
# signatures and synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5, 64, 4096, 4097, 150_000])
def test_pow2_bucket_matches_reference(n):
    assert A.pow2_bucket(n) == jautotune.pow2_bucket(n)


@pytest.mark.parametrize("frac", [0.0, 1e-7, 2.3e-5, 0.05, 0.5, 1.0, 3.0])
def test_sparsity_bucket_matches_reference(frac):
    assert A.sparsity_bucket(frac) == jautotune.sparsity_bucket(frac)


@pytest.mark.parametrize("rows,nnz,cols,epilogue", [
    (64, 500, 64, None), (64, 512, 64, "relu"), (128, 4096, 100, None),
    (150_000, 36_000_000, 150_000, "none")])
def test_signature_matches_reference_from_values_and_fakes(rows, nnz, cols,
                                                           epilogue):
    """The same problem keys the same in both packages, save for the
    port's last part, the floating operands' dtypes; and a traced (fake)
    tensor keys as its real tensor does: a trace-mode record serves a
    host-mode call's lookup and a fresh process's."""
    shapes = {"a": (nnz,), "colidx": (nnz,), "rowstr": (rows + 1,),
              "iv": (cols,)}
    b = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    b.update(rows=rows, nnz=nnz)
    want = jautotune.signature_of("spmv_csr", "CSR", "cpu", b,
                                  epilogue=epilogue) + "|dt:" + ",".join(
        f"{k}=float32" for k in sorted(shapes))
    with FakeTensorMode():
        fakes = {k: torch.empty(s) for k, s in shapes.items()}
    fakes.update(rows=rows, nnz=nnz)
    if nnz < 10_000:
        assert A.signature_of("spmv_csr", "CSR", "cpu", _torch_binding(b),
                              epilogue=epilogue) == want
    assert A.signature_of("spmv_csr", "CSR", "cpu", fakes,
                          epilogue=epilogue) == want


def test_similar_problems_share_a_signature():
    a = A.signature_of("spmv_csr", "CSR", "cuda", _np_binding(64, 500))
    b = A.signature_of("spmv_csr", "CSR", "cuda", _np_binding(64, 512))
    c = A.signature_of("spmv_csr", "CSR", "cuda", _np_binding(128, 4096))
    assert a == b != c and a.startswith("spmv_csr|CSR|cuda|")


def test_synthesize_operands_gives_valid_indices():
    with FakeTensorMode():
        b = {"a": torch.empty(100), "colidx": torch.empty(100,
                                                          dtype=torch.int32),
             "rowstr": torch.empty(33, dtype=torch.int32),
             "iv": torch.empty(48), "perm": torch.empty(32, dtype=torch.int32),
             "idx": torch.empty(40, 8, dtype=torch.int32)}
    b.update(rows=32, nnz=100, experts=5)
    ops = A.synthesize_operands(b)
    assert A.signature_of("x", "CSR", "cpu", ops) \
        == A.signature_of("x", "CSR", "cpu", b)
    assert all(ops[k].dtype == b[k].dtype for k in ("colidx", "perm", "idx"))
    assert 0 <= int(ops["colidx"].min()) and int(ops["colidx"].max()) < 48
    ptr = ops["rowstr"].long()
    assert int(ptr[0]) == 0 and int(ptr[-1]) == 100
    assert bool((torch.diff(ptr) >= 0).all())
    assert sorted(ops["perm"].tolist()) == list(range(32))
    assert 0 <= int(ops["idx"].min()) and int(ops["idx"].max()) < 5
    ref = jautotune.synthesize_operands(_np_binding(32, 100, 48))
    assert np.asarray(ref["rowstr"]).tolist() == \
        A.synthesize_operands(_torch_binding(_np_binding(32, 100, 48)))[
            "rowstr"].tolist()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_round_trip(tmp_path):
    path = tmp_path / "at.json"
    rec = {"harness": "cuda.ell", "best_s": 1e-4,
           "timings": {"cuda.ell": 1e-4}}
    A.AutotuneCache(path, registry_fingerprint="fp1").put("sig", "host", rec)
    back = A.AutotuneCache(path, registry_fingerprint="fp1").load()
    assert back.entries["sig"]["host"] == rec
    doc = json.loads(path.read_text())
    assert doc["schema"] == 4 and doc["registry"] == "fp1"


def test_store_keeps_every_concurrent_writer(tmp_path):
    path = tmp_path / "at.json"
    errors = []

    def writer(i):
        try:
            A.AutotuneCache(path, registry_fingerprint="fp").put(
                f"sig-{i}", "host", {"harness": f"h{i}", "timings": {}})
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    merged = A.AutotuneCache(path, registry_fingerprint="fp").load()
    assert set(merged.entries) == {f"sig-{i}" for i in range(8)}


def test_store_drops_a_file_of_another_fingerprint(tmp_path):
    path = tmp_path / "at.json"
    A.AutotuneCache(path, registry_fingerprint="old").put(
        "sig", "host", {"harness": "x", "timings": {}})
    fresh = A.AutotuneCache(path, registry_fingerprint="new").load()
    assert fresh.entries == {} and fresh.stats.invalidations == 1


@pytest.mark.parametrize("schema", [1, 2, 3, 5])
def test_store_drops_a_schema_other_than_4(tmp_path, schema):
    """The port never wrote another schema: no migration, the whole file
    goes (the JAX package migrates 1-3)."""
    path = tmp_path / "at.json"
    path.write_text(json.dumps({"schema": schema, "registry": "fp",
                                "entries": {"sig": {"host": {
                                    "harness": "x", "timings": {}}}}}))
    store = A.AutotuneCache(path, registry_fingerprint="fp").load()
    assert store.entries == {} and store.stats.invalidations == 1


def test_store_moves_a_torn_file_aside(tmp_path):
    path = tmp_path / "at.json"
    path.write_text('{"schema": 4, "regis')
    store = A.AutotuneCache(path, registry_fingerprint="fp").load()
    assert store.entries == {} and store.stats.corrupt_recoveries == 1
    assert (tmp_path / "at.json.corrupt").exists() and not path.exists()


def test_store_lives_apart_from_the_reference(monkeypatch, tmp_path):
    monkeypatch.delenv("LILAC_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert A.default_cache_path() == tmp_path / "lilac-torch" / \
        "autotune.json"
    assert A.default_cache_path() != jautotune.default_cache_path()


def test_registry_version_bump_retunes():
    reg = _toy_registry(["toy.a", "toy.b"])
    fp0 = reg.fingerprint()
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    t0 = reg.autotuner
    t0.select("spmv_csr", "CSR", "cpu", "host", cands,
              _torch_binding(_np_binding()), _ctx(), default_name="toy.b")
    assert t0.stats.timing_calls == 2
    # a new harness moves the fingerprint: the store's records are dropped
    lilac.register_spec("""
HARNESS toy.c implements spmv_csr
  formats CSR;
""", {"toy.c": _body}, registry=reg)
    assert reg.fingerprint() != fp0 and reg.autotuner is not t0
    t1 = reg.autotuner
    t1.select("spmv_csr", "CSR", "cpu", "host", cands,
              _torch_binding(_np_binding()), _ctx(), default_name="toy.b")
    assert t1.stats.timing_calls == 2 and t1.stats.disk_hits == 0


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def test_budget_zero_falls_back_to_default():
    reg = _toy_registry(["toy.a", "toy.b"])
    tuner = A.Autotuner(registry_fingerprint="fp", budget=0)
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    assert tuner.select("spmv_csr", "CSR", "cpu", "host", cands,
                        _torch_binding(_np_binding()), _ctx(),
                        default_name="toy.b") is None
    assert tuner.stats.timing_calls == 0 and tuner.stats.fallbacks == 1
    assert not tuner.last_decision.definitive


def test_budget_limits_what_is_timed(monkeypatch):
    reg = _toy_registry(["toy.a", "toy.b", "toy.c", "toy.d"])
    calls = _rig(monkeypatch, {("toy.a", "default"): 1e-3,
                               ("toy.b", "default"): 1e-3,
                               ("toy.c", "default"): 1e-3,
                               ("toy.d", "default"): 2e-3})
    tuner = A.Autotuner(registry_fingerprint="fp", budget=2)
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    h = tuner.select("spmv_csr", "CSR", "cpu", "host", cands,
                     _torch_binding(_np_binding()), _ctx(),
                     default_name="toy.d")
    # the default ranks first: it is timed even though it is registered last
    assert [c[0] for c in calls] == ["toy.d", "toy.a"]
    assert h.name == "toy.a" and tuner.stats.timing_calls == 2


def test_successive_halving_picks_a_rigged_best(monkeypatch):
    reg = _toy_registry(["toy.tuned", "toy.plain"],
                        tune="  tune block in {32, 8, 64, 128};\n"
                             "  tune warps in {4, 8};\n"
                             "  constraint block * warps <= 512;")
    tuned = reg.get("spmv_csr", "toy.tuned")
    assert len(tuned.schedules) == 7
    best = {"block": 64, "warps": 8}
    costs = {("toy.plain", "default"): 5e-3}
    for s in tuned.schedules:
        costs[("toy.tuned", A.schedule_key(s))] = 1e-4 if s == best else 3e-3
    calls = _rig(monkeypatch, costs)
    tuner = A.Autotuner(registry_fingerprint="fp", budget=2)
    ctx = _ctx()
    h = tuner.select("spmv_csr", "CSR", "cpu", "host",
                     reg.candidates("spmv_csr", "CSR", "cpu", "host"),
                     _torch_binding(_np_binding()), ctx,
                     default_name="toy.plain")
    assert h.name == "toy.tuned" and ctx.schedule == best
    assert tuner.last_decision.schedule == best
    elim = [c for c in calls if c[2] == 1]
    full = [c for c in calls if c[2] != 1]
    assert tuner.stats.elimination_calls == len(elim) > 0
    assert tuner.stats.timing_calls == len(full) <= 2
    rec = tuner.cache.get(tuner.last_decision.sig, "host")
    assert rec["schedule"] == best
    assert [best, None, 1e-4] in rec["variants"]["toy.tuned"]


def test_variant_cap_keeps_every_default():
    reg = _toy_registry(["toy.tuned", "toy.plain"],
                        tune="  tune block in {32, 8, 64, 128};")
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    pool = A.Autotuner(budget=8, max_variants=3)._variant_pool(cands)
    assert len(pool) == 3
    assert pool[0] == (cands[0], {"block": 32}, None)
    assert pool[1] == (cands[1], None, None)


def test_fuse_dimension_at_an_epilogue_site():
    reg = HarnessRegistry()
    lilac.register_spec("""
HARNESS toy.fused implements spmv_csr
  formats CSR;
  fuse epilogue;
  tune block in {32, 8};
""", {"toy.fused": _body}, registry=reg)
    (h,) = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    tuner = A.Autotuner(budget=8)
    assert [(s, f) for _, s, f in tuner._variant_pool([h], "relu")] == [
        ({"block": 32}, True), ({"block": 32}, False),
        ({"block": 8}, True), ({"block": 8}, False)]
    assert [(s, f) for _, s, f in tuner._variant_pool([h], None)] == [
        ({"block": 32}, None), ({"block": 8}, None)]


def test_a_stale_pinned_schedule_retunes(monkeypatch):
    reg = _toy_registry(["toy.tuned"], tune="  tune block in {32, 8};")
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    binding = _torch_binding(_np_binding())
    sig = A.signature_of("spmv_csr", "CSR", "cpu", binding)
    calls = _rig(monkeypatch, {("toy.tuned", "block=32"): 2e-3,
                               ("toy.tuned", "block=8"): 1e-3})
    tuner = A.Autotuner(registry_fingerprint="fp", budget=8)
    tuner.cache.put(sig, "host", {
        "harness": "toy.tuned", "best_s": 1e-4,
        "timings": {"toy.tuned": 1e-4}, "marshal_s": {}, "reuse": 100.0,
        "schedule": {"block": 1024}, "schedules": {}},
        persist=False)
    h = tuner.select("spmv_csr", "CSR", "cpu", "host", cands, binding,
                     _ctx(), default_name="toy.tuned")
    assert tuner.stats.remeasures == 1 and len(calls) == 2
    assert h.name == "toy.tuned" and tuner.last_decision.schedule == \
        {"block": 8}


def test_a_raising_variant_is_eliminated_with_its_entries():
    """A candidate that raises (a repack or kernel that cannot fit) is
    eliminated, the data-plane entries it built are dropped, and the
    winner's stay."""
    from repro_torch.core.spec import repack

    @repack("toy_pack_ok", override=True)
    def _ok(b):
        return torch.ones(3)

    @repack("toy_pack_big", override=True)
    def _big(b):
        return torch.ones(3)

    reg = HarnessRegistry()

    def blows_up(b, ctx, *, big):
        raise torch.OutOfMemoryError("no room")

    lilac.register_spec("""
HARNESS toy.big implements spmv_csr
  formats CSR;
  marshal big = toy_pack_big(a);
HARNESS toy.ok implements spmv_csr
  formats CSR;
  marshal ok = toy_pack_ok(a);
""", {"toy.big": blows_up,
      "toy.ok": lambda b, ctx, *, ok: torch.zeros(b["rows"])}, registry=reg)
    plane = DataPlane()
    ctx = _ctx(plane)
    tuner = A.Autotuner(budget=8)
    h = tuner.select("spmv_csr", "CSR", "cpu", "host",
                     reg.candidates("spmv_csr", "CSR", "cpu", "host"),
                     _torch_binding(_np_binding()), ctx)
    assert h.name == "toy.ok" and tuner.stats.eliminated == 1
    assert tuner.last_report["toy.big"] is None
    assert [k[0] for k in plane._store] == ["toy_pack_ok"]


def test_a_refused_variant_is_eliminated():
    """A harness that refuses its operands or schedule with a ValueError
    leaves the race; the other candidate wins."""
    reg = HarnessRegistry()

    def refuses(b, ctx):
        raise ValueError("tm must divide Tp")

    lilac.register_spec("""
HARNESS toy.picky implements spmv_csr
  formats CSR;
HARNESS toy.ok implements spmv_csr
  formats CSR;
""", {"toy.picky": refuses, "toy.ok": _body}, registry=reg)
    tuner = A.Autotuner(budget=8)
    h = tuner.select("spmv_csr", "CSR", "cpu", "host",
                     reg.candidates("spmv_csr", "CSR", "cpu", "host"),
                     _torch_binding(_np_binding()), _ctx())
    assert h.name == "toy.ok" and tuner.stats.eliminated == 1
    assert tuner.last_report["toy.picky"] is None


@pytest.mark.parametrize("mode", ["host", "trace"])
def test_a_broken_candidate_raises_instead_of_losing(mode):
    """A candidate that fails for another reason (a kernel that does not
    build or launch raises RuntimeError) is not eliminated: the error
    reaches the caller and nothing is stored."""
    reg = HarnessRegistry()

    def broken(b, ctx):
        raise RuntimeError("nvcc failed")

    lilac.register_spec("""
HARNESS toy.broken implements spmv_csr
  formats CSR;
HARNESS toy.ok implements spmv_csr
  formats CSR;
""", {"toy.broken": broken, "toy.ok": _body}, registry=reg)
    tuner = A.Autotuner(budget=8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tuner.select("spmv_csr", "CSR", "cpu", mode,
                     reg.candidates("spmv_csr", "CSR", "cpu", mode),
                     _torch_binding(_np_binding()), _ctx())
    assert tuner.stats.eliminated == 0 and tuner.stats.stores == 0
    assert not tuner.cache.path.exists()


def test_a_broken_kernel_raises_through_the_compiled_call(monkeypatch):
    """The same through ``lilac.compile(..., policy="autotune")``: a
    harness whose body raises RuntimeError neither quietly loses the race
    to a plain ``torch.*`` harness nor ends the user's call.  The tuner's
    error names the candidate; containment quarantines that candidate,
    loudly, and races again without it, and the call returns the
    uncompiled program's answer.  The race that broke stores nothing."""
    h = REGISTRY.get("spmv_csr", "torch.ell")

    def broken(b, ctx):
        raise RuntimeError("launch failed: cudaError 700")

    monkeypatch.setattr(h, "fn", broken)
    _, csr, v = _operands()
    args = (csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    fast = lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu")
    with pytest.warns(LilacContainmentWarning, match="'torch.ell'"):
        out = fast(*args)
    torch.testing.assert_close(out, naive(*args), atol=1e-4, rtol=1e-4)
    (reason,) = [r["reason"] for k, r in shared_quarantine().active().items()
                 if k.startswith("spmv_csr|torch.ell|")]
    assert "cudaError 700" in reason
    assert fast.last_selections[0][1] != "torch.ell"
    stored = [r for modes in REGISTRY.autotuner.cache.entries.values()
              for r in modes.values()]
    assert all(r["harness"] != "torch.ell" and "torch.ell" not in r["timings"]
               for r in stored)
    assert fast.resilience_info()["containment"]["contained_exceptions"] == 1


def test_a_losing_candidate_frees_its_entries_before_the_next(monkeypatch):
    """The data plane keeps a candidate's marshaled value only while it is
    the cheapest so far: a loser's repack (72 GB of dense tiles at NPB-C)
    must not starve the candidates timed after it."""
    from repro_torch.core.spec import repack

    cost = [0.0]
    seen = {}

    def body(name, seconds):
        def fn(b, ctx, *, m):
            cost[0] = seconds
            seen[name] = sorted(k[0] for k in ctx.cache._store)
            return torch.zeros(b["rows"])
        return fn

    def elapsed(fn, device):
        fn()
        return cost[0]

    monkeypatch.setattr(A, "_elapsed", elapsed)
    reg = HarnessRegistry()
    text, bodies = "", {}
    for name, seconds in (("slow", 1.0), ("fast", 1e-3), ("third", 2.0)):
        repack(f"toy_pack_{name}", override=True)(lambda b: torch.ones(2))
        text += f"""
HARNESS toy.{name} implements spmv_csr
  formats CSR;
  marshal m = toy_pack_{name}(a);
"""
        bodies[f"toy.{name}"] = body(name, seconds)
    lilac.register_spec(text, bodies, registry=reg)
    plane = DataPlane()
    h = A.Autotuner(budget=8).select(
        "spmv_csr", "CSR", "cpu", "host",
        reg.candidates("spmv_csr", "CSR", "cpu", "host"),
        _torch_binding(_np_binding()), _ctx(plane), default_name="toy.slow")
    assert h.name == "toy.fast"
    assert seen["third"] == ["toy_pack_fast", "toy_pack_third"]
    assert [k[0] for k in plane._store] == ["toy_pack_fast"]


def test_the_winner_minimizes_the_amortized_cost(monkeypatch):
    """A fast kernel behind a slow repack wins only where ``reuse`` calls
    amortize it; a record re-derives its winner for another ``reuse``
    with zero re-timing."""
    reg = _toy_registry(["toy.packed", "toy.plain"])
    reg.get("spmv_csr", "toy.packed").marshal = ("clause",)
    _rig(monkeypatch, {("toy.packed", "default"): 1e-4,
                       ("toy.plain", "default"): 1e-3})
    monkeypatch.setattr(A.Autotuner, "_marshal_cost", staticmethod(
        lambda h, ctx: 0.5 if h.name == "toy.packed" else 0.0))
    cands = reg.candidates("spmv_csr", "CSR", "cpu", "host")
    binding = _torch_binding(_np_binding())
    winners = {}
    for reuse in (100.0, 1e4):
        REGISTRY.reset_autotuner()
        tuner = A.Autotuner(registry_fingerprint=f"fp{reuse}", budget=8)
        ctx = _ctx(DataPlane(MarshalPolicy(reuse=reuse)))
        winners[reuse] = tuner.select("spmv_csr", "CSR", "cpu", "host",
                                      cands, binding, ctx).name
        rec = tuner.cache.get(tuner.last_decision.sig, "host")
        amort = rec["amortized_s"]
        assert rec["harness"] == min(amort, key=amort.get)
        assert amort["toy.packed"] == pytest.approx(1e-4 + 0.5 / reuse)
    assert winners == {100.0: "toy.plain", 1e4: "toy.packed"}
    # the 1e4 record served at reuse 100: re-derived, not re-timed
    timed = tuner.stats.timing_calls
    h = tuner.select("spmv_csr", "CSR", "cpu", "host", cands, binding,
                     _ctx(DataPlane(MarshalPolicy(reuse=100.0))))
    assert h.name == "toy.plain" and tuner.stats.timing_calls == timed


def test_record_external_seeds_the_winner():
    reg = _toy_registry(["toy.a", "toy.b"])
    tuner = A.Autotuner(registry_fingerprint="fp", budget=8)
    binding = _torch_binding(_np_binding())
    assert tuner.record_external("spmv_csr", "CSR", "cpu", "host", binding,
                                 {"toy.a": 2e-3, "toy.b": 1e-3},
                                 schedules={}) == "toy.b"
    h = tuner.select("spmv_csr", "CSR", "cpu", "host",
                     reg.candidates("spmv_csr", "CSR", "cpu", "host"),
                     binding, _ctx())
    assert h.name == "toy.b" and tuner.stats.timing_calls == 0
    assert set(tuner.pinned().values()) == {"toy.b"}


# ---------------------------------------------------------------------------
# tune clauses
# ---------------------------------------------------------------------------

def test_tune_clauses_round_trip_and_constraints_filter():
    text = """HARNESS toy.t implements spmv_csr
  tune tm in {128, 64, 256};
  tune tn in {64, 128};
  constraint tm * tn <= 8192;"""
    decl = lilac.parse_harness(text)
    assert lilac.parse_harness(str(decl)) == decl
    (h,) = lilac.build_harnesses(decl, _body)
    assert h.schedules[0] == h.default_schedule == {"tm": 128, "tn": 64}
    assert h.schedules == ({"tm": 128, "tn": 64}, {"tm": 64, "tn": 64},
                           {"tm": 64, "tn": 128})


def test_kernel_harnesses_declare_their_launch_parameters():
    ell = REGISTRY.get("spmv_ell", "cuda.ell")
    gmm = REGISTRY.get("moe_ffn", "cuda.gmm")
    assert [s["rows_per_slab"] for s in ell.schedules] == [32]
    assert [s["tm"] for s in gmm.schedules] == [128, 64, 256]
    for comp in ("spmv_csr", "spmm_csr"):
        assert REGISTRY.get(comp, "cuda.bcsr").schedules == ()
    assert REGISTRY.get("spmv_csr", "cuda.ell").schedules == ()


def test_schedules_reach_the_body_as_keyword_arguments():
    seen = []
    reg = HarnessRegistry()
    lilac.register_spec("""
HARNESS toy.t implements spmv_csr
  formats CSR;
  tune block in {32, 8};
""", {"toy.t": lambda b, ctx, *, block: seen.append(block)}, registry=reg)
    h = reg.get("spmv_csr", "toy.t")
    ctx = _ctx()
    h({}, ctx)
    ctx.schedule = {"block": 8}
    h({}, ctx)
    assert seen == [32, 8]
    ctx.schedule = {"warps": 4}
    with pytest.raises(lilac.SpecError, match="unknown param"):
        h({}, ctx)


# ---------------------------------------------------------------------------
# the fused and unfused realizations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp,name", [("spmv_ell", "cuda.ell"),
                                       ("spmv_ell", "torch.ell")])
@pytest.mark.parametrize("epilogue", ["relu", "none", "silu"])
def test_unfused_realization_adds_the_bias_once(comp, name, epilogue):
    """The tuner times (and may pin) a fuse-capable harness unfused: the
    body must not add the bias that the rewrite adds after it."""
    rng = np.random.default_rng(3)
    b = {"val": torch.from_numpy(rng.standard_normal((40, 16))
                                 .astype(np.float32)),
         "col_ind": torch.from_numpy(rng.integers(0, 30, (40, 16))
                                     .astype(np.int32)),
         "vector": torch.from_numpy(rng.standard_normal(30)
                                    .astype(np.float32)),
         "bias": torch.from_numpy(rng.standard_normal(40).astype(np.float32)),
         "rows": 40}
    h = REGISTRY.get(comp, name)
    outs = []
    for fuse in (True, False):
        ctx = CallCtx(mode="host", cache=DataPlane(), format="ELL",
                      platform="cpu", epilogue=epilogue, fuse=fuse)
        outs.append(A.Autotuner._as_runtime(h, b, ctx))
    want = lilac.apply_epilogue((b["val"] * b["vector"][b["col_ind"]])
                                .sum(1), b["bias"], epilogue)
    for out in outs:
        torch.testing.assert_close(out, want, **TOL)


# ---------------------------------------------------------------------------
# host-mode autotune end to end
# ---------------------------------------------------------------------------

def test_host_autotune_matches_reference_and_warm_starts_in_process():
    ref, csr, v = _operands()
    want = np.asarray(jlilac.compile(naive_jax, mode="host",
                                     policy="autotune")(
        ref.val, ref.col_ind, ref.row_ptr, jnp.asarray(v)))
    fast = lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu")
    args = (csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    np.testing.assert_allclose(fast(*args).numpy(), want, **TOL)
    tuner = REGISTRY.autotuner
    assert tuner.stats.timing_calls >= 4 and tuner.cache.path.exists()
    winner = fast.last_selections[0][1]
    # what was timed: every host candidate on the CPU; the winner has the
    # least amortized cost of those measured
    rec = tuner.cache.get(tuner.last_decision.sig, "host")
    assert set(rec["timings"]) == {"torch.segment", "torch.ell",
                                   "torch.bcsr", "torch.dense"}
    assert winner == rec["harness"] == min(rec["amortized_s"],
                                           key=rec["amortized_s"].get)
    assert all(rec["marshal_s"][n] > 0 for n in rec["timings"]
               if n != "torch.segment")
    # the data plane keeps no loser's marshaled value
    kept = {k[2] for k in fast.cache._store}
    lost = {REGISTRY.get("spmv_csr", n).marshal[0].dst
            for n in rec["timings"] if n not in ("torch.segment", winner)}
    assert lost and not kept & lost
    timed = tuner.stats.timing_calls
    for _ in range(3):
        np.testing.assert_allclose(fast(*args).numpy(), want, **TOL)
        assert fast.last_selections[0][1] == winner
    again = lilac.compile(naive, mode="host", policy="autotune",
                          platform="cpu")
    again(*args)
    assert again.last_selections[0][1] == winner
    assert tuner.stats.timing_calls == timed


_SUBPROC = textwrap.dedent("""
    import json
    import numpy as np, torch
    from repro_torch import lilac
    from repro_torch.core import REGISTRY
    from repro_torch.sparse import random as trandom

    def naive(val, col, row_ptr, v):
        rows = row_ptr.shape[0] - 1
        row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                      output_size=val.shape[0])
        return torch.zeros(rows).index_add_(0, row, val * v[col])

    csr = trandom.random_spd_csr(200, 9, seed=1)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(200)
                         .astype(np.float32))
    fast = lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu")
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    print(json.dumps({"selected": fast.last_selections[0][1],
                      "stats": REGISTRY.autotuner.stats.as_dict()}))
""")


def test_host_autotune_warm_starts_in_a_fresh_process(tmp_path):
    cache = tmp_path / "fresh.json"
    env = dict(os.environ, LILAC_TORCH_AUTOTUNE_CACHE=str(cache),
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))

    def run():
        p = subprocess.run([sys.executable, "-c", _SUBPROC], env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        return json.loads(p.stdout.strip().splitlines()[-1])

    first = run()
    assert first["stats"]["timing_calls"] > 0 and cache.exists()
    mtime = cache.stat().st_mtime
    second = run()
    assert second["selected"] == first["selected"]
    assert second["stats"]["timing_calls"] == 0
    assert second["stats"]["disk_hits"] == 1
    assert cache.stat().st_mtime == mtime


def test_autotune_disable_measures_nothing(monkeypatch):
    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_DISABLE", "1")
    _, csr, v = _operands()
    fast = lilac.compile(naive, mode="host", policy="autotune",
                         platform="cpu")
    fast(csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    tuner = REGISTRY.autotuner
    assert tuner.stats.timing_calls == 0 and tuner.stats.fallbacks >= 1
    assert fast.last_selections[0][1] == "torch.segment"
    assert not tuner.cache.path.exists()


def test_marshal_policy_off_repacks_every_call():
    _, csr, v = _operands()
    args = (csr.val, csr.col_ind, csr.row_ptr, torch.from_numpy(v))
    fast = lilac.compile(naive, mode="host", policy="cuda.ell",
                         platform="cpu", marshal_policy="off")
    assert fast.cache is None
    for _ in range(2):
        torch.testing.assert_close(fast(*args), naive(*args), **TOL)
    assert lilac.MarshalPolicy.parse(None) == lilac.MarshalPolicy()
    small = lilac.DataPlane(lilac.MarshalPolicy(max_entries=2))
    for i in range(3):
        small.get("p", (torch.full((2,), float(i)),), lambda: i)
    assert len(small._store) == 2 and small.stats.evictions == 1
    with pytest.raises(ValueError):
        lilac.MarshalPolicy.parse("sometimes")


def test_dtype_tunes_apart():
    """One MoE shape in f32 and in bf16: two tuner keys, differing only in
    their dtype part, and two records in the store (K4's body differs by
    dtype, so a decision for one must not serve the other)."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(0)
    sigs = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = L.moe_params(L.moe_spec(32, 16, 4, dtype), gen)
        x = torch.randn(24, 32, generator=gen).to(dtype)
        gate, idx, _ = L.moe_router(p, x[None], 2)
        fast = lilac.compile(L._moe_naive_2d, policy="autotune",
                             platform="cpu")
        fast(x, gate[0], idx[0], p["wg"], p["wu"], p["wd"])
        dec = REGISTRY.autotuner.last_decision
        assert dec.source == "measured"
        sigs[dtype] = dec.sig
    f32, bf16 = sigs[torch.float32], sigs[torch.bfloat16]
    assert f32 != bf16
    assert f32.split("|dt:")[0] == bf16.split("|dt:")[0]
    assert "x=float32" in f32 and "x=bfloat16" in bf16
    path = A.default_cache_path()
    entries = json.loads(path.read_text())["entries"]
    assert "trace" in entries[f32] and "trace" in entries[bf16]
