"""Scans in the port against the JAX package (docs/transforms.md, "scan:
detect once, reuse every iteration").  The same programs, written with
``lax.scan`` / ``fori_loop`` for ``repro.lilac.compile`` and with
``torch._higher_order_ops.scan.scan`` for ``repro_torch.lilac.compile``,
on inputs made from a seed with numpy:

* the counterpart of ``tests/test_transforms.py::
  test_scan_body_detected_once_and_reused``: a 4-step power iteration,
  one ``scan_body`` match holding one ``spmv_csr`` in both packages, 2
  detections on the first call and none on the steady one;
* CG as one scan of 25 steps on a random SPD CSR, against the
  reference's compiled CG and the port's own uncompiled scan;
* the ``fori_loop`` skeletons of ``tests/test_detect.py`` and
  ``tests/test_rewrite.py`` (COO SpMV, dot product) as scans, with the
  counter as the scan's slice of ``torch.arange(n)`` or carried: one
  ``loop`` match with the reference's bindings, a trace of the same size
  at two nnz;
* the pass manager on a scan entry: no plan and no plan-cache record,
  a fault in the inner harness running the whole scan plain, a named
  policy and the autotuner selecting for the inner matches;
* trace mode: the rewritten graph's scan holds the selected harness.

Runs on the CPU, the harnesses' plain versions standing in for the
kernels (the card's case is ``tests/test_torch_kernels_gpu.py::
test_k1_inside_a_rewritten_scan_body_matches_plain``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan

from repro import lilac as jlilac
from repro.core import detect as JD
from repro_torch import lilac
from repro_torch.core import detect as TD
from repro_torch.core import faults
from repro_torch.core import plan as P
from repro_torch.core.harness import REGISTRY
from repro_torch.core.resilience import (LilacContainmentWarning,
                                         reset_shared_quarantine)

ROWS, COLS = 64, 48          # tests/test_transforms.py's problem
POWER_STEPS = 4
CG_N, CG_ITERS = 96, 25      # NPB CG's cgitmax
LOOP_ROWS, LOOP_COLS = 16, 8  # tests/test_rewrite.py's loop


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """The port's stores in this test's directory, no ambient chaos plan
    and no shadow checks."""
    for name, file in (("AUTOTUNE", "autotune"), ("PLAN", "plans"),
                       ("QUARANTINE", "quarantine")):
        monkeypatch.setenv(f"LILAC_TORCH_{name}_CACHE",
                           str(tmp_path / f"{file}.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE", "LILAC_TORCH_PLAN_CACHE_DISABLE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    REGISTRY.reset_autotuner()
    P.reset_shared_plan_caches()
    yield
    P.reset_shared_plan_caches()


def _csr(rows, cols, density, seed, spd=False):
    """(val, col, row_ptr) of a seeded random matrix, as numpy arrays; with
    ``spd`` a symmetric, diagonally dominant square one."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((rows, cols)) < density) \
        * rng.standard_normal((rows, cols))
    if spd:
        dense = (dense + dense.T) / 2
        dense[np.diag_indices(rows)] = np.abs(dense).sum(1) + 1.0
    r, c = np.nonzero(dense)
    row_ptr = np.searchsorted(r, np.arange(rows + 1)).astype(np.int32)
    return (dense[r, c].astype(np.float32), c.astype(np.int32), row_ptr)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _spy_detect():
    """Count ``Detector.detect`` calls of the port (restored by the
    caller), as tests/test_transforms.py counts the reference's."""
    calls = {"n": 0}
    real = TD.Detector.detect

    def spy(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    TD.Detector.detect = spy
    return calls, lambda: setattr(TD.Detector, "detect", real)


def _structure(matches):
    """Each match as (computation, variant), a scan_body with its inner
    matches' structure."""
    return [(m.computation, m.variant) + ((_structure(m.body[1]),)
                                         if m.body is not None else ())
            for m in matches]


# -- the programs, in both packages ------------------------------------------

def spmv_jax(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = jnp.repeat(jnp.arange(rows, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=rows)


def spmv_torch(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    return torch.zeros(rows).index_add_(0, row, val * v[col])


def power_jax(val, col, row_ptr, v0):        # tests/test_transforms.py
    def step(v, _):
        w = spmv_jax(val, col, row_ptr, v)[:COLS]
        return w / (jnp.linalg.norm(w) + 1e-6), None

    out, _ = jax.lax.scan(step, v0, None, length=POWER_STEPS)
    return out


def power_torch(val, col, row_ptr, v0):
    def step(v, _):
        w = spmv_torch(val, col, row_ptr, v)[:COLS]
        return w / (torch.linalg.norm(w) + 1e-6), ()

    out, _ = scan(step, v0, torch.arange(POWER_STEPS))
    return out


def cg_jax(val, col, row_ptr, b):
    x = jnp.zeros_like(b)
    r = b - spmv_jax(val, col, row_ptr, x)
    rs = jnp.dot(r, r)

    def step(c, _):
        x, r, p, rs = c
        ap = spmv_jax(val, col, row_ptr, p)
        alpha = rs / jnp.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.dot(r, r)
        return (x, r, r + (rs_new / rs) * p, rs_new), None

    (x, _, _, _), _ = jax.lax.scan(step, (x, r, r, rs), None,
                                   length=CG_ITERS)
    return x


def cg_torch(val, col, row_ptr, b):
    x = torch.zeros_like(b)
    r = b - spmv_torch(val, col, row_ptr, x)
    p = r.clone()               # a carry may not alias another
    rs = torch.dot(r, r)

    def step(c, _):
        x, r, p, rs = c
        ap = spmv_torch(val, col, row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        return (x, r, r + (rs_new / rs) * p, rs_new), ()

    (x, _, _, _), _ = scan(step, (x, r, p, rs), torch.arange(CG_ITERS))
    return x


@pytest.fixture(scope="module")
def problem():
    val, col, row_ptr = _csr(ROWS, COLS, 0.12, seed=7)
    v0 = np.random.default_rng(8).standard_normal(COLS).astype(np.float32)
    return _both(val, col, row_ptr, v0)


# -- detect once, reuse every iteration ----------------------------------------

@pytest.mark.parametrize("mode", ["host", "trace"])
def test_scan_body_detected_once_and_reused(problem, mode):
    """A sparse step inside a scan: one top-level detection and one of the
    body on the first call, none on the steady call; one ``scan_body``
    match holding one ``spmv_csr``, as in the reference; the output
    within 1e-5 of the reference's compiled and plain power iteration."""
    jargs, targs = problem
    ref = np.asarray(power_jax(*jargs))
    jfast = jlilac.compile(power_jax)
    jout = np.asarray(jfast(*jargs))
    calls, restore = _spy_detect()
    try:
        fast = lilac.compile(power_torch, mode=mode, platform="cpu")
        out = fast(*targs)
        first = calls["n"]
        again = fast(*targs)
        steady = calls["n"] - first
    finally:
        restore()
    for want in (jout, ref):
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, again)
    assert first == 2, "one top-level detect + one scan-body descent"
    assert steady == 0, "iteration reuse: no re-detection on later calls"
    # the reference's jaxpr spells the norm sqrt(sum(w * w)), which its
    # body also detects as a dot product; torch's linalg_vector_norm is
    # one operator
    (jm,) = jfast.last_report.matches
    assert jm.variant == "scan_body"
    assert [(i.computation, i.variant) for i in jm.body[1]] == \
        [("spmv_csr", "vectorized"), ("dotproduct", "vectorized")]
    assert _structure(fast.last_report.matches) == \
        [("scan_body", "scan_body", [("spmv_csr", "vectorized")])]
    (m,) = fast.last_report.matches
    (inner,) = m.body[1]
    assert inner.format == "CSR" and inner.binding["rows"] == ROWS
    # the inner binding names the body's placeholders: the closed-over
    # matrix and the carried vector
    assert all(v.op == "placeholder" for k, v in inner.binding.items()
               if k in ("a", "colidx", "rowstr", "iv"))
    assert [(mm.computation, n) for mm, n in fast.last_selections] == \
        [("spmv_csr", "torch.segment")]


def test_cg_as_one_scan_matches_the_reference_and_the_uncompiled_scan():
    """CG of 25 steps on a random SPD CSR written as one scan: in both
    packages the r0 SpMV and its dot product at top level and one
    ``scan_body`` holding the step's SpMV and two dot products; the
    iterate within 1e-5 (relative L2) of the reference's compiled CG and
    of the port's uncompiled scan, in host and trace mode."""
    val, col, row_ptr = _csr(CG_N, CG_N, 0.08, seed=11, spd=True)
    b = np.ones(CG_N, np.float32)
    jargs, targs = _both(val, col, row_ptr, b)
    jfast = jlilac.compile(cg_jax)
    jx = np.asarray(jfast(*jargs))
    plain = cg_torch(*targs).numpy()
    want = [("spmv_csr", "vectorized"), ("dotproduct", "vectorized"),
            ("scan_body", "scan_body", [("spmv_csr", "vectorized"),
                                        ("dotproduct", "vectorized"),
                                        ("dotproduct", "vectorized")])]
    assert _structure(jfast.last_report.matches) == want

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for mode in ("host", "trace"):
        fast = lilac.compile(cg_torch, mode=mode, platform="cpu")
        x = fast(*targs).numpy()
        assert _structure(fast.last_report.matches) == want
        assert rel(x, jx) <= 1e-5
        assert rel(x, plain) <= 1e-5
    resid = np.linalg.norm(b - spmv_torch(*targs[:3], torch.from_numpy(x))
                           .numpy())
    assert resid <= 1e-4 * np.linalg.norm(b)


# -- the fori_loop skeletons as scans (tests/test_detect.py, test_rewrite.py) --

def coo_loop_jax(val, row, col, vec):       # tests/test_detect.py
    def body(j, out):
        return out.at[row[j]].add(val[j] * vec[col[j]])
    return jax.lax.fori_loop(0, val.shape[0], body, jnp.zeros(LOOP_ROWS))


def coo_loop_arange(val, row, col, vec):
    def step(out, j):
        k = j.reshape(1)
        return out.index_add(0, row[k], val[k] * vec[col[k]]), ()

    out, _ = scan(step, torch.zeros(LOOP_ROWS), torch.arange(val.shape[0]))
    return out


def coo_loop_counter(val, row, col, vec):
    def step(carry, _):
        i, out = carry
        k = i.reshape(1)
        return (i + 1, out.index_put((row[k],), val[k] * vec[col[k]],
                                     accumulate=True)), ()

    (i, out), _ = scan(step, (torch.zeros((), dtype=torch.int64),
                              torch.zeros(LOOP_ROWS)),
                       torch.empty(val.shape[0], 0))
    return out, i


def dot_loop_jax(a, b):                      # tests/test_detect.py
    return jax.lax.fori_loop(0, a.shape[0], lambda i, acc: acc + a[i] * b[i],
                             jnp.float32(0))


def dot_loop_arange(a, b):
    def step(acc, i):
        k = i[None]
        return acc + (a[k] * b[k]).sum(), ()

    acc, _ = scan(step, torch.zeros(()), torch.arange(a.shape[0]))
    return acc


def dot_loop_counter(a, b):
    def step(carry, _):
        i, acc = carry
        k = i.reshape(1)
        return (i + 1, acc + a.index_select(0, k) * b.index_select(0, k)), ()

    (i, acc), _ = scan(step, (torch.zeros((), dtype=torch.int32),
                              torch.zeros(1)), torch.arange(a.shape[0]))
    return acc, i


def _loop_args(kind, n, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "coo":                        # tests/test_rewrite.py
        return (rng.standard_normal(n).astype(np.float32),
                rng.integers(0, LOOP_ROWS, n).astype(np.int32),
                rng.integers(0, LOOP_COLS, n).astype(np.int32),
                rng.standard_normal(LOOP_COLS).astype(np.float32))
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _named(binding, inputs):
    """A binding with each graph input named by its position."""
    return {k: ("arg", inputs.index(v)) if any(v is x for x in inputs)
            else ("num", v) for k, v in binding.items()}


def _nodes(gm):
    """Operators in the graph and in every scan body under it."""
    n = sum(1 for x in gm.graph.nodes if x.op == "call_function")
    return n + sum(_nodes(getattr(gm, x.target)) for x in gm.graph.nodes
                   if x.op == "get_attr" and isinstance(
                       getattr(gm, x.target), torch.fx.GraphModule))


LOOPS = [("coo", coo_loop_jax, coo_loop_arange, ("spmv_csr", "COO")),
         ("coo", coo_loop_jax, coo_loop_counter, ("spmv_csr", "COO")),
         ("dot", dot_loop_jax, dot_loop_arange, ("dotproduct", "DOT")),
         ("dot", dot_loop_jax, dot_loop_counter, ("dotproduct", "DOT"))]


@pytest.mark.parametrize("kind,fj,ft,what", LOOPS,
                         ids=lambda x: getattr(x, "__name__", None))
def test_loop_skeleton_on_a_scan(kind, fj, ft, what):
    """A ``fori_loop`` skeleton written as a scan, the counter the scan's
    slice of ``torch.arange(n)`` or carried from zero: one ``loop`` match
    anchored at the scan, with the reference's bindings (each naming the
    same argument or number); the traced graph's size the same at nnz 40
    and 80; the compiled output within 1e-5 of the reference's compiled
    loop, in host and trace mode, the carried counter ending at n."""
    n = 40
    jargs, targs = _both(*_loop_args(kind, n))
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(fj)(*jargs))
    (jm,) = JD.Detector().detect(ncj, normalize=False).matches
    gm = TD.trace(ft, targs)
    (tm,) = TD.Detector().detect(gm).matches
    assert (jm.computation, jm.format, jm.variant) == what + ("loop",)
    assert (tm.computation, tm.format, tm.variant) == what + ("loop",)
    assert tm.anchor.target is torch.ops.higher_order.scan
    phs = [x for x in gm.graph.nodes if x.op == "placeholder"]
    assert _named(tm.binding, phs) == _named(jm.binding,
                                             list(ncj.jaxpr.invars))
    wide = TD.trace(ft, _both(*_loop_args(kind, 2 * n))[1])
    assert _nodes(wide) == _nodes(gm)
    ref = np.asarray(jlilac.compile(fj, mode="host")(*jargs))
    for mode in ("host", "trace"):
        fast = lilac.compile(ft, mode=mode, platform="cpu")
        out = fast(*targs)
        assert [(m.variant, m.format) for m in fast.last_report.matches] \
            == [("loop", what[1])]
        acc, i = out if isinstance(out, tuple) else (out, None)
        np.testing.assert_allclose(acc.numpy().reshape(ref.shape), ref,
                                   atol=1e-5, rtol=1e-5)
        if i is not None:
            assert int(i) == n and i.dtype == ft(*targs)[1].dtype


# -- the pass manager on a scan entry -----------------------------------------

def test_scan_entries_neither_bake_nor_persist(problem, tmp_path):
    """A ``scan_body`` entry never bakes, with the reason in
    ``plan_info()["bake_errors"]`` as in the reference, and leaves no
    plan-cache record: a fresh function on the same store detects again."""
    jargs, targs = problem
    jfast = jlilac.compile(power_jax, mode="host")
    jfast(*jargs), jfast(*jargs)
    jinfo = jfast.plan_info()
    assert jinfo["baked"] == 0 and any("scan-body" in e
                                       for e in jinfo["bake_errors"])
    fast = lilac.compile(power_torch, mode="host", platform="cpu")
    fast(*targs), fast(*targs)
    info = fast.plan_info()
    assert info["baked"] == 0 and info["no_bake"] == 1
    assert any("scan-body" in e for e in info["bake_errors"])
    assert info["plan_cache_stats"]["stores"] == 0
    assert not (tmp_path / "plans.json").exists()
    calls, restore = _spy_detect()
    try:
        lilac.compile(power_torch, mode="host", platform="cpu")(*targs)
    finally:
        restore()
    assert calls["n"] == 2


def test_a_fault_in_the_inner_harness_runs_the_scan_plain(problem,
                                                          monkeypatch):
    """``kernel_raise`` on every harness (``LILAC_TORCH_FAULTS``): each
    candidate of the inner match fails and is quarantined, the match is
    disabled, and the whole scan runs as the plain graph node, equal to
    the uncompiled scan; no harness ran."""
    _, targs = problem
    monkeypatch.setenv("LILAC_TORCH_FAULTS", "kernel_raise")
    faults.load_env()
    fast = lilac.compile(power_torch, mode="host", platform="cpu")
    with pytest.warns(LilacContainmentWarning):
        out = fast(*targs)
    np.testing.assert_array_equal(out.numpy(), power_torch(*targs).numpy())
    info = fast.resilience_info()
    assert info["disabled_matches"] == 1
    assert info["containment"]["fallbacks"] == 1
    assert info["containment"]["contained_exceptions"] >= 1
    assert fast.last_selections == []
    with warnings.catch_warnings():
        warnings.simplefilter("error", LilacContainmentWarning)
        again = fast(*targs)            # the entry runs plain, quietly
    assert torch.equal(out, again)


class _AtAttempt(faults.FaultPlan):
    """A fault plan whose rules fire at one attempt of their site only."""

    def __init__(self, spec: str, at: int):
        super().__init__(faults.parse_spec(spec))
        self.at = at

    def fires(self, kind, site):
        if self._rule_for(kind, site) is None:
            return False
        n = self.attempts(kind, site)
        self._attempts[(kind, site)] = n + 1
        if n != self.at:
            return False
        self.fired.append((kind, site, n))
        return True


@pytest.mark.parametrize("kind", ["kernel_raise", "nan_output"])
def test_a_fault_at_a_later_step_runs_the_whole_scan_plain(problem, kind,
                                                           monkeypatch):
    """A fault of the inner harness at step 2 only, after two good steps:
    no other harness takes over for the steps left.  The harness is
    quarantined, the match disabled, and the call runs again as the plain
    scan, equal to the uncompiled one.  A raise is contained where it
    happens, a non-finite output when the loop's outputs are read, once,
    after its last step."""
    _, targs = problem
    monkeypatch.setattr(faults, "ACTIVE",
                        _AtAttempt(f"{kind}:torch.ell", at=2))
    fast = lilac.compile(power_torch, mode="host", policy="torch.ell",
                         platform="cpu")
    with pytest.warns(LilacContainmentWarning, match="torch.ell"):
        out = fast(*targs)
    assert faults.ACTIVE.fired == [(kind, "torch.ell", 2)]
    # a raise ends the loop at step 2; a NaN is seen after the last step
    assert faults.ACTIVE.attempts(kind, "torch.ell") == \
        (3 if kind == "kernel_raise" else POWER_STEPS)
    np.testing.assert_array_equal(out.numpy(), power_torch(*targs).numpy())
    info = fast.resilience_info()
    assert info["disabled_matches"] == 1
    assert info["containment"]["fallbacks"] == 1
    assert info["containment"]["quarantines"] == 1
    assert (info["containment"]["contained_exceptions"],
            info["containment"]["nonfinite_outputs"]) == \
        ((1, 0) if kind == "kernel_raise" else (0, 1))
    assert fast.last_selections == []


def test_a_named_policy_pins_the_inner_match(problem):
    """``policy="torch.ell"`` selects the marshaling harness for the SpMV
    inside the scan: one repack on the first call, none on the second.
    The closed-over matrix is the same tensors at every step, so the data
    plane is consulted on the first step of a call only (one miss, then
    one hit), the later steps getting the ELL from the loop's front.  The
    output within 1e-5 of the uncompiled scan."""
    _, targs = problem
    fast = lilac.compile(power_torch, mode="host", policy="torch.ell",
                         platform="cpu")
    out = fast(*targs)
    assert [(m.computation, n) for m, n in fast.last_selections] == \
        [("spmv_csr", "torch.ell")]
    assert (fast.cache.stats.misses, fast.cache.stats.hits) == (1, 0)
    fast(*targs)
    assert (fast.cache.stats.misses, fast.cache.stats.hits) == (1, 1)
    np.testing.assert_allclose(out.numpy(), power_torch(*targs).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_the_autotuner_and_the_joint_search_see_the_inner_matches():
    """Under ``policy="autotune"`` the CG scan's five matches (two at top
    level, three in the body) are tuned once each and pinned, the joint
    search runs over all five, and the second call times nothing."""
    val, col, row_ptr = _csr(CG_N, CG_N, 0.08, seed=11, spd=True)
    _, targs = _both(val, col, row_ptr, np.ones(CG_N, np.float32))
    fast = lilac.compile(cg_torch, mode="host", policy="autotune",
                         platform="cpu")
    out = fast(*targs)
    (entry,) = fast._compiled.values()
    assert sorted(entry.pins) == list(range(5))
    assert [m.computation for m, _ in fast.last_selections] == \
        ["spmv_csr", "dotproduct", "spmv_csr", "dotproduct", "dotproduct"]
    (joint,) = fast.plan_info()["joint"]
    assert len(joint["assignment"]) == 5
    timed = REGISTRY.autotuner.stats.timing_calls
    assert torch.equal(fast(*targs), out)
    assert REGISTRY.autotuner.stats.timing_calls == timed
    x = cg_torch(*targs).numpy()
    assert np.linalg.norm(out.numpy() - x) <= 1e-5 * np.linalg.norm(x)


# -- trace mode ----------------------------------------------------------------

def coo_power_torch(val, row, col, v0):
    """The power iteration over a COO matrix, its step accumulating with
    ``index_put_``."""
    def step(v, _):
        out = torch.zeros(ROWS)
        out.index_put_((row,), v[col] * val, accumulate=True)
        w = out[:COLS]
        return w / (torch.linalg.norm(w) + 1e-6), ()

    out, _ = scan(step, v0, torch.arange(POWER_STEPS))
    return out


def test_trace_mode_emits_the_scan_on_the_rewritten_body(problem):
    """The rewritten graph holds one ``torch.ops.higher_order.scan`` whose
    body holds the selected harness (``torch.segment``: an ``index_add``
    where the program's step has an ``index_put``), and its output equals
    host mode's bit for bit."""
    val, col, row_ptr = _csr(ROWS, COLS, 0.12, seed=7)
    row = np.repeat(np.arange(ROWS, dtype=np.int32), np.diff(row_ptr))
    v0 = np.random.default_rng(8).standard_normal(COLS).astype(np.float32)
    _, targs = _both(val, row, col, v0)
    fast = lilac.compile(coo_power_torch, platform="cpu")
    gm = fast.graph_for(*targs)
    scans = [n for n in gm.graph.nodes
             if n.target is torch.ops.higher_order.scan]
    assert len(scans) == 1
    body = getattr(gm, scans[0].args[0].target)
    ops = {n.target for n in body.graph.nodes if n.op == "call_function"}
    assert torch.ops.aten.index_add.default in ops
    assert torch.ops.aten.index_put.default not in ops
    out = fast(*targs)
    assert [(m.computation, m.format, n)
            for m, n in fast.last_selections] == \
        [("spmv_csr", "COO", "torch.segment")]
    host = lilac.compile(coo_power_torch, mode="host", platform="cpu")
    assert torch.equal(out, host(*targs))
    np.testing.assert_allclose(out.numpy(), coo_power_torch(*targs).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_per_step_outputs_stack_and_reverse(problem):
    """A scan with per-step outputs over ``xs`` of its own, forward and
    reversed: the compiled scan stacks them as the uncompiled one does
    (``reverse`` flips ``xs`` and the stacked outputs around the scan
    node, so the rewrite sees the forward loop)."""
    jargs, targs = problem
    shifts = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (POWER_STEPS, COLS)).astype(np.float32))

    def f(val, col, row_ptr, v0, shifts, reverse):
        def step(v, s):
            w = spmv_torch(val, col, row_ptr, v)[:COLS] + s
            n = torch.linalg.norm(w)
            return w / (n + 1e-6), n

        return scan(step, v0, shifts, reverse=reverse)

    for reverse in (False, True):
        def g(*a):
            return f(*a, reverse=reverse)

        want = g(*targs, shifts)
        for mode in ("host", "trace"):
            fast = lilac.compile(g, mode=mode, platform="cpu")
            got = fast(*targs, shifts)
            assert [m.variant for m in fast.last_report.matches] == \
                ["scan_body"]
            for a, b in zip(got, want):
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                           rtol=1e-5)
