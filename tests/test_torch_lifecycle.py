"""The How language's lifecycle in the port against the JAX package: the
persistence hooks (``persistent``, ``BeforeFirstExecution``,
``AfterLastExecution``, ``@lilac.hook`` and ``hooks=``), ``ReadObject``
(the paper's Fig. 14) and the compile options (``enabled=False``,
``CompileOptions``, the decorator form, ``cache=`` / ``detector=``).

The cases are the reference's (``tests/test_spec.py``'s hook cases and
``CompileOptions``, ``tests/test_marshal.py``'s ``ReadObject``,
``tests/test_rewrite.py``'s disabled pass, ``tests/test_dataplane.py``'s
shared data plane, ``tests/test_dispatch.py``'s stateful harness that
never bakes), each run through both packages where both can take the
same input, with the event logs compared exactly and ``enabled=False``
at atol 0; plus the autotuner's timed call running ``setup`` once, the
spec log replaying hooks into a fresh registry, and the lifecycle phase
of ``chip_smoke.py`` on a small matrix (its plain versions on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lilac as jlilac
from repro.core.harness import HarnessRegistry as JRegistry
from repro_torch import lilac
from repro_torch.core import faults
from repro_torch.core import plan as P
from repro_torch.core import spec as S
from repro_torch.core.harness import REGISTRY, HarnessRegistry
from repro_torch.core.resilience import reset_shared_quarantine


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    # the port's stores in this test's directory, no ambient chaos plan
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


def _csr(rows=48, cols=40, density=0.15, seed=0):
    """A seeded CSR as numpy arrays (val f32, col and row_ptr int32)."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((rows, cols)).astype(np.float32)
    dense *= rng.random((rows, cols)) < density
    nz = np.nonzero(dense)
    counts = np.bincount(nz[0], minlength=rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    vec = rng.standard_normal(cols).astype(np.float32)
    return dense[nz], nz[1].astype(np.int32), row_ptr, vec


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype)
    return out.index_add_(0, row, val * v[col])


def jnaive(rows, nnz):
    def f(val, col, row_ptr, v):
        row = jnp.repeat(jnp.arange(rows, dtype=jnp.int32),
                         jnp.diff(row_ptr), total_repeat_length=nnz)
        return jax.ops.segment_sum(val * v[col], row, num_segments=rows)
    return f


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


DOT = lilac.CallCtx(mode="host", cache=None, format="DOT", platform="cpu")


# -- persistence hooks (tests/test_spec.py) -----------------------------------

def _hooked_events(pkg, registry, ctx, zeros):
    """tests/test_spec.py:161 on either package: the event log, the
    persistent dict before the first call and the two outputs."""
    events = []

    @pkg.harness("""
    HARNESS t.persist implements dotproduct
      persistent handle;
      BeforeFirstExecution t_init;
      AfterLastExecution t_fini;
    """, registry=registry, hooks={
        "t_init": lambda state: (events.append("init"),
                                 state.__setitem__("handle", 42)),
        "t_fini": lambda state: events.append("fini"),
    })
    def t_persist(b, ctx):
        return b["a"] * 0 + h.persistent["handle"]

    h = registry.get("dotproduct", "t.persist")
    before = dict(h.persistent)
    outs = [np.asarray(h({"a": zeros}, ctx)) for _ in range(2)]
    after_calls = list(events)
    h.release()
    h.release()                     # already down: no second fini
    return before, outs, after_calls, events


def test_persistent_state_hooks_match_the_reference():
    """BeforeFirstExecution runs once before the first call and
    AfterLastExecution on release, with the same log and answers in both
    packages."""
    want = _hooked_events(
        jlilac, JRegistry(), jlilac.CallCtx(mode="host", cache=None,
                                            format="DOT"), np.zeros(2))
    got = _hooked_events(lilac, HarnessRegistry(), DOT, torch.zeros(2))
    assert got[0] == want[0] == {"handle": None}
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] == ["init"]
    assert got[3] == want[3] == ["init", "fini"]


def test_hook_registered_with_the_decorator():
    """``@lilac.hook`` registers a name any later spec can cite; a second
    function under the same name needs override."""
    name = "t_lifecycle_global_init"
    try:
        @lilac.hook(name)
        def init(state):
            state["handle"] = "up"

        with pytest.raises(lilac.SpecError, match="already registered"):
            lilac.hook(name)(lambda state: None)
        reg = HarnessRegistry()
        lilac.register_spec(f"""
HARNESS t.global implements dotproduct
  persistent handle;
  BeforeFirstExecution {name};
""", {"t.global": lambda b, c: 1.0}, registry=reg)
        h = reg.get("dotproduct", "t.global")
        assert h.setup is init and h.teardown is None
        h({}, DOT)
        assert h.persistent == {"handle": "up"}
    finally:
        lilac.HOOKS.pop(name, None)


def test_unknown_repack_and_hook_are_spec_errors():
    """Both fail at registration, and nothing is half-registered
    (tests/test_spec.py:195)."""
    reg = HarnessRegistry()
    with pytest.raises(lilac.SpecError, match="unknown BeforeFirstExecution"):
        @lilac.harness("""
        HARNESS t.nohook implements dotproduct
          BeforeFirstExecution missing_hook;
        """, registry=reg)
        def _a(b, ctx):
            return 0
    with pytest.raises(lilac.SpecError, match="unknown AfterLastExecution"):
        @lilac.harness("""
        HARNESS t.nofini implements dotproduct
          AfterLastExecution missing_hook;
        """, registry=reg)
        def _c(b, ctx):
            return 0
    with pytest.raises(lilac.SpecError, match="unknown repack"):
        @lilac.harness("""
        HARNESS t.nopack implements dotproduct
          host_only;
          marshal x = missing_pack(a);
        """, registry=reg)
        def _b(b, ctx, *, x):
            return x
    assert not reg.harnesses_for("dotproduct")


def _shared_events(pkg, registry, ctx):
    """tests/test_spec.py:340 on either package."""
    events = []

    @pkg.harness("""
    HARNESS t.shared implements spmv_csr, spmv_coo
      persistent handle;
      BeforeFirstExecution s_init;
      AfterLastExecution s_fini;
    """, registry=registry, hooks={
        "s_init": lambda state: events.append("init"),
        "s_fini": lambda state: events.append("fini"),
    })
    def t_shared(b, ctx):
        return 0

    h_csr = registry.get("spmv_csr", "t.shared")
    h_coo = registry.get("spmv_coo", "t.shared")
    log = [h_csr.persistent is h_coo.persistent]
    h_csr({}, ctx)
    h_coo({}, ctx)
    log.append(list(events))
    h_coo.release()                 # a sibling that never ran tears down
    h_csr.release()                 # already down: no second fini
    log.append(list(events))
    h_csr({}, ctx)                  # a later call through any sets up
    h_csr.release()
    log.append(list(events))
    return log


def test_multi_computation_harness_shares_persistent_state():
    want = _shared_events(jlilac, JRegistry(), jlilac.CallCtx(
        mode="host", cache=None, format="CSR"))
    got = _shared_events(lilac, HarnessRegistry(), lilac.CallCtx(
        mode="host", cache=None, format="CSR", platform="cpu"))
    assert got == want == [True, ["init"], ["init", "fini"],
                           ["init", "fini", "init", "fini"]]


def test_override_replacement_tears_down_live_harness():
    """register(..., override=True) tears a live harness down before
    dropping it, and never runs a hook of one that never started
    (tests/test_spec.py:377)."""
    reg = HarnessRegistry()
    events = []
    h1 = lilac.Harness("t.live", "dotproduct", lambda b, c: 1.0,
                       setup=lambda s: events.append("init"),
                       teardown=lambda s: events.append("fini"))
    reg.register(h1)
    h1({}, DOT)
    assert events == ["init"]
    reg.register(lilac.Harness("t.live", "dotproduct", lambda b, c: 2.0),
                 override=True)
    assert events == ["init", "fini"]
    h3 = lilac.Harness("t.live", "dotproduct", lambda b, c: 3.0,
                       setup=lambda s: events.append("init3"),
                       teardown=lambda s: events.append("fini3"))
    reg.register(h3, override=True)
    reg.register(lilac.Harness("t.live", "dotproduct", lambda b, c: 4.0),
                 override=True)
    assert events == ["init", "fini"]        # h3 never started: no hook


def test_spec_log_replays_hooks_into_a_fresh_registry():
    """A spec registered globally with ``hooks=`` is logged with them, and
    ``register_builtins(fresh)`` builds its harness anew (the builtins
    too), its own persistent state apart from the global one's."""
    events = []
    text = """
    HARNESS t.replayed implements dotproduct
      persistent handle;
      BeforeFirstExecution r_init;
    """
    try:
        lilac.register_spec(text, {"t.replayed": lambda b, c: 1.0},
                            hooks={"r_init": lambda s: events.append("init")})
        fresh = lilac.register_builtins(HarnessRegistry())
        h, g = (r.get("dotproduct", "t.replayed") for r in (fresh, REGISTRY))
        assert h is not g and h.persistent is not g.persistent
        h({}, DOT)
        g({}, DOT)
        assert events == ["init", "init"]
        assert [x.name for x in fresh.harnesses_for("spmv_csr")] == \
            [x.name for x in REGISTRY.harnesses_for("spmv_csr")]
    finally:
        REGISTRY._by_comp["dotproduct"] = [
            x for x in REGISTRY._by_comp["dotproduct"]
            if x.name != "t.replayed"]
        REGISTRY.reset_autotuner()
        S._GLOBAL_SPEC_LOG[:] = [e for e in S._GLOBAL_SPEC_LOG
                                 if not any(d.name == "t.replayed"
                                            for d in e[0].harnesses)]


# -- ReadObject (tests/test_marshal.py) ---------------------------------------

def _read_object_log(make, read_object_cls):
    log = []
    ro = read_object_cls(
        construct=lambda a: log.append("construct") or a.sum(),
        update=lambda a, s: log.append("update") or a.sum(),
        destruct=lambda s: log.append("destruct"),
    )
    a = make(np.ones(8, np.float32))
    states = [ro.read(a), ro.read(a), ro.read(a * 2),
              ro.read(make(np.ones(16, np.float32)))]
    ro.release()
    ro.release()                    # nothing held: nothing destructed
    return log, [float(s) for s in states]


def test_read_object_event_log_matches_the_reference():
    """Construct before first use and on a shape change, update on a
    content change, destruct between constructs and on release; the same
    log and states as the reference's."""
    want = _read_object_log(jnp.asarray, jlilac.ReadObject)
    got = _read_object_log(torch.from_numpy, lilac.ReadObject)
    assert got == want
    assert got[0] == ["construct", "update", "destruct", "construct",
                      "destruct"]


def test_read_object_sees_an_in_place_edit_and_reads_no_host_copy():
    """A content change made in place on a large tensor (sampled
    fingerprint) updates; the shape comes from the tensor itself."""
    log = []
    ro = lilac.ReadObject(construct=lambda a: log.append("c") or 1,
                          update=lambda a, s: log.append("u") or s + 1)
    big = torch.ones(1 << 16)          # 256 KiB: a sampled fingerprint
    assert ro.read(big) == 1 and ro.read(big) == 1
    big.mul_(2)
    assert ro.read(big) == 2 and log == ["c", "u"]
    exact = lilac.ReadObject(construct=lambda a: 0,
                             update=lambda a, s: s + 1, exact=True)
    exact.read(big)
    big[12345] = -1.0                  # off the sample grid
    assert exact.read(big) == 1


# -- the compile options --------------------------------------------------------

def test_disabled_pass_is_identity():
    """``enabled=False`` returns the function's own answer at atol 0 in
    both packages, and the port traces and detects nothing
    (tests/test_rewrite.py:73)."""
    val, col, row_ptr, vec = _csr(seed=1)
    rows = row_ptr.shape[0] - 1
    jf = jnaive(rows, val.shape[0])
    jopt = jlilac.compile(jf, enabled=False)
    jargs = [jnp.asarray(a) for a in (val, col, row_ptr, vec)]
    np.testing.assert_allclose(np.asarray(jopt(*jargs)),
                               np.asarray(jf(*jargs)), atol=0)
    args = _torch(val, col, row_ptr, vec)
    for mode in ("trace", "host"):
        opt = lilac.compile(naive, enabled=False, mode=mode, platform="cpu")
        out = opt(*args)
        assert torch.equal(out, naive(*args))
        assert opt.stats["traces"] == opt.stats["detects"] == 0
        assert opt.last_selections == [] and opt.plan_info()["entries"] == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(jf(*jargs)),
                               rtol=1e-5, atol=1e-5)


def _dot(a, b):
    return torch.sum(a * b)


def test_compile_options_and_decorator_form():
    """tests/test_spec.py:403 on the port: the options dataclass, keyword
    overrides of its fields, the decorator form; an unknown option (the
    reference's ``donate_args`` included) is a TypeError."""
    f = lilac.compile(_dot, platform="cpu")
    assert isinstance(f, lilac.LilacFunction) and f.mode == "trace"
    opts = lilac.CompileOptions(mode="host", platform="cpu")
    f = lilac.compile(_dot, options=opts)
    assert f.mode == "host" and f.platform == "cpu"
    f = lilac.compile(_dot, options=opts, mode="trace", policy="torch.dot")
    assert f.mode == "trace" and f.policy == "torch.dot"
    assert opts.mode == "host"                 # the options stay as given

    @lilac.compile(mode="host", device="cpu")
    def g(a, b):
        return torch.sum(a * b)

    assert isinstance(g, lilac.LilacFunction) and g.mode == "host"
    a = torch.arange(4.0)
    torch.testing.assert_close(g(a, a), _dot(a, a))
    assert [m.computation for m, _ in g.last_selections] == ["dotproduct"]
    for bad in ("donate_args", "no_such_option"):
        with pytest.raises(TypeError, match="unknown compile option"):
            lilac.compile(_dot, **{bad: ()})
    with pytest.raises(ValueError, match="mode must be"):
        lilac.compile(_dot, mode="jit", platform="cpu")


def test_keyword_and_options_forms_select_and_bake_alike():
    """The keyword form and ``CompileOptions`` give the same bits, the
    same selection and the same baking."""
    val, col, row_ptr, vec = _csr(seed=2)
    args = _torch(val, col, row_ptr, vec)
    kw = lilac.compile(naive, mode="host", policy="torch.ell",
                       platform="cpu")
    op = lilac.compile(naive, options=lilac.CompileOptions(
        mode="host", policy="torch.ell", platform="cpu"))
    outs = [[f(*args) for _ in range(2)] for f in (kw, op)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert [n for _, n in kw.last_selections] == \
        [n for _, n in op.last_selections] == ["torch.ell"]
    assert kw.plan_info()["baked"] == op.plan_info()["baked"] == 1


def test_plan_cache_shared_across_two_compiled_functions():
    """One DataPlane passed as ``cache=`` to two compiled functions
    (tests/test_dataplane.py:119): the second function's repack starts
    from the CSR the first loaded (the binding is loaded once), and a
    repeat call is a pure cache hit.  The port never transits DENSE on the
    way to BCSR (marshal.NO_TRANSIT), where the reference rides the dense
    intermediate: the shared node is the CSR."""
    val, col, row_ptr, vec = _csr(seed=3)
    args = _torch(val, col, row_ptr, vec)
    plane = lilac.DataPlane()
    dense_f = lilac.compile(naive, mode="host", policy="torch.dense",
                            cache=plane, bake=False, platform="cpu")
    bcsr_f = lilac.compile(naive, mode="host", policy="torch.bcsr",
                           cache=plane, bake=False, platform="cpu")
    assert dense_f.cache is plane and bcsr_f.cache is plane
    out_d = dense_f(*args)
    loader_runs = plane.stats.loader_runs
    out_b = bcsr_f(*args)
    torch.testing.assert_close(out_d, out_b, rtol=1e-5, atol=1e-5)
    assert plane.stats.loader_runs == loader_runs       # loaded once
    ps = plane.plans[("csr_binding", "BCSR8x128")]
    assert plane.stats.shared_edge_hits >= 1 and ps.last_path[0] == "CSR"
    edges = plane.stats.edge_runs
    bcsr_f(*args)
    assert plane.stats.edge_runs == edges and ps.hits == 1


def test_injected_detector_decides_what_is_found():
    """``detector=`` replaces the default detector: one with no matcher
    finds nothing and the function runs as written."""
    from repro_torch.core.detect import Detector

    val, col, row_ptr, vec = _csr(seed=4)
    args = _torch(val, col, row_ptr, vec)
    blind = lilac.compile(naive, mode="host", platform="cpu",
                          detector=Detector([]))
    seeing = lilac.compile(naive, mode="host", platform="cpu")
    torch.testing.assert_close(blind(*args), seeing(*args))
    assert blind.last_report.matches == [] and blind.last_selections == []
    assert blind.plan_info()["plan_cache"] is None   # keeps no records
    assert [m.computation for m, _ in seeing.last_selections] == ["spmv_csr"]


def test_injected_detector_refuses_a_named_plan_cache(tmp_path):
    """A function with its own detector keeps no plan records, so a
    plan cache named beside it is an error, not silently dropped; the
    default and a disabled one are accepted."""
    from repro_torch.core.detect import Detector

    for named in (str(tmp_path / "plans.json"),
                  P.PlanCache(str(tmp_path / "p2.json"))):
        with pytest.raises(ValueError, match="plan_cache"):
            lilac.compile(naive, mode="host", platform="cpu",
                          detector=Detector([]), plan_cache=named)
    for quiet in (None, "default", "off", False):
        f = lilac.compile(naive, mode="host", platform="cpu",
                          detector=Detector([]), plan_cache=quiet)
        assert f.plan_info()["plan_cache"] is None


def _stateful_spmv(registry, events, body=None):
    """A hook-bearing spmv_csr harness on ``registry``: setup and teardown
    logged, the body the torch.segment one."""
    from repro_torch.core.harness import _spmv_segment

    lilac.register_spec("""
HARNESS t.stateful implements spmv_csr, spmv_coo
  formats CSR, COO;
  persistent handle;
  BeforeFirstExecution st_init;
  AfterLastExecution st_fini;
""", {"t.stateful": body or _spmv_segment}, registry=registry, hooks={
        "st_init": lambda s: events.append("init"),
        "st_fini": lambda s: events.append("fini")})


def test_hook_bearing_harness_never_bakes():
    """After tests/test_dispatch.py:424: a harness with hooks and
    persistent state stays on the interpreter, and plan_info says why;
    its setup ran once over every call."""
    reg = lilac.register_builtins(HarnessRegistry())
    events = []
    _stateful_spmv(reg, events)
    val, col, row_ptr, vec = _csr(seed=5)
    args = _torch(val, col, row_ptr, vec)
    fast = lilac.compile(naive, mode="host", policy="t.stateful",
                         registry=reg, platform="cpu")
    for _ in range(3):
        torch.testing.assert_close(fast(*args), naive(*args))
    info = fast.plan_info()
    assert info["baked"] == 0 and info["no_bake"] == 1
    assert "lifecycle hooks" in info["bake_errors"][0] \
        and "t.stateful" in info["bake_errors"][0]
    assert events == ["init"]
    reg.get("spmv_csr", "t.stateful").release()
    assert events == ["init", "fini"]


def test_autotuner_timed_candidate_sets_up_once():
    """The tuner times a hook-bearing candidate through the harness call,
    so its setup runs once, before its first timed call, and later calls
    set up nothing."""
    reg = lilac.register_builtins(HarnessRegistry())
    events, calls = [], []
    from repro_torch.core.harness import _spmv_segment

    def body(b, ctx):
        calls.append(1)
        return _spmv_segment(b, ctx)

    _stateful_spmv(reg, events, body)
    val, col, row_ptr, vec = _csr(seed=6)
    args = _torch(val, col, row_ptr, vec)
    tuned = lilac.compile(naive, mode="host", policy="autotune",
                          registry=reg, platform="cpu")
    for _ in range(3):
        torch.testing.assert_close(tuned(*args), naive(*args))
    assert len(calls) >= 2            # timed by the tuner, not only called
    assert events == ["init"]


# -- chip_smoke.py's lifecycle phase, rehearsed on the CPU ----------------------

def test_chip_smoke_lifecycle_phase_on_the_cpu(monkeypatch):
    """The phase on a small matrix: its plain versions stand in for K1 on
    the CPU, so the launch count (and only it) fails the phase's check."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    mats = cs.matrices(0, cpu, npb=(1500, 41), hpcg=(12, 11, 10))
    res = cs.lifecycle_path(*mats["npb"], 0, cpu)
    assert res["setups"] == 1 and res["constructs"] == 1
    assert res["updates"] == 0 and res["rel_to_naive"] <= cs.CG_RTOL
    assert res["edit"]["updates"] == 1 \
        and res["edit"]["rel_to_naive"] <= cs.CG_RTOL
    assert res["after_release"]["teardowns"] == 1 \
        and res["after_release"]["destructs"] == 1
    assert res["plan_info"]["baked"] == 0 \
        and "lifecycle hooks" in res["plan_info"]["bake_errors"][0]
    assert res["disabled"]["equal"] and res["disabled"]["detects"] == 0
    assert res["options"]["equal"] and res["options"]["same_selection"]
    with pytest.raises(RuntimeError, match="K1"):
        cs.check_lifecycle_path(res)
