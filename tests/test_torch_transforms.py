"""Transforms through the port (docs/transforms.md), held against the JAX
package's ``tests/test_transforms.py`` on the same seeded inputs:

  * ``lilac.compile(torch.func.grad(f))`` — compile-of-grad: the gradient's
    graph is detected (the backward SpMVᵀ is a COO SpMV) with the
    reference's ``(computation, format)`` list, gradients as ``jax.grad``'s
    and ``torch.func.grad``'s, and the entry bakes;
  * grad-of-compile — ``.backward()`` and ``torch.func.grad`` through a
    compiled call, for every ``spmv_csr`` harness of the registry (the
    marshaling ones and the kernels' through their ``vjp`` clauses);
  * ``policy="cuda.ell"`` on the direct ELL form through its ``vjp`` clause
    (the port's ``autograd.Function`` on the graph, ``cuda.ell`` in
    ``last_selections``: the reference's R3 is not copied), the epilogue
    unfused under differentiation, a missing gradient raising;
  * detection under an ambient ``make_fx`` grad trace;
  * the custom ops' autograd formulas under ``torch.autograd.gradcheck``
    in f64 on their plain path.

Tolerances: atol = rtol = 1e-5 for f32 SpMV gradients (1e-4 in the
property test, as the reference's); gradcheck's f64 defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro import lilac as jlilac
from repro.sparse import csr_from_dense, random_csr
from repro.sparse.random import random_dense_sparse
from repro_torch import lilac
from repro_torch.core import faults
from repro_torch.core import harness as H
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.models.layers import _moe_naive_2d

ROWS, COLS = 64, 48
TOL = dict(atol=1e-5, rtol=1e-5)
SPMV_HARNESSES = ("torch.segment", "torch.ell", "torch.bcsr", "torch.dense",
                  "cuda.ell", "cuda.bcsr")


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
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))


@pytest.fixture(scope="module")
def problem():
    csr = random_csr(ROWS, COLS, density=0.12, seed=7)
    vec = np.random.default_rng(8).standard_normal(COLS).astype(np.float32)
    j = (jnp.asarray(csr.val), jnp.asarray(csr.col_ind),
         jnp.asarray(csr.row_ptr), jnp.asarray(vec))
    t = tuple(torch.from_numpy(np.asarray(a)) for a in j)
    return j, t


def naive_jax(val, col, row_ptr, vec):
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * vec[col], row, num_segments=ROWS)


def naive(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def loss(val, col, row_ptr, vec):
    return (naive(val, col, row_ptr, vec) ** 2).sum()


def _close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b),
                                   **(tol or TOL))


def _ref_grads(j):
    """The reference's gradients of sum(naive(val, .., vec)^2) in (val,
    vec), and its compile-of-grad match list."""
    grad = jax.grad(lambda v, c, r, x: jnp.sum(naive_jax(v, c, r, x) ** 2),
                    argnums=(0, 3))
    fast = jlilac.compile(grad)
    fast(*j)
    pairs = [(m.computation, m.format) for m in fast.last_report.matches]
    return grad(*j), pairs


# ---------------------------------------------------------------------------
# compile-of-grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "trace"])
def test_compile_of_grad_detects_the_spmv_transpose(problem, mode):
    """The gradient's graph holds the forward CSR SpMV and the SpMVᵀ (a
    COO SpMV of the entries into ``new_zeros``, gathered by
    ``index_select`` through ``expand``): both detected, as the reference
    detects them, and the gradients equal ``jax.grad``'s and
    ``torch.func.grad``'s."""
    j, t = problem
    want, pairs = _ref_grads(j)
    assert pairs == [("spmv_csr", "CSR"), ("spmv_csr", "COO")]
    grad = torch.func.grad(loss, argnums=(0, 3))
    fast = lilac.compile(grad, mode=mode, platform="cpu")
    got = fast(*t)
    assert [(m.computation, m.format)
            for m in fast.last_report.matches] == pairs
    assert len(fast.last_selections) == 2
    _close(got, want)
    _close(got, grad(*t))


def test_compile_of_grad_bakes_and_serves_its_plan(problem):
    _, t = problem
    fast = lilac.compile(torch.func.grad(loss, argnums=(0, 3)), mode="host",
                         platform="cpu", policy="cuda.ell")
    outs = [fast(*t) for _ in range(3)]
    info = fast.plan_info()
    assert info["baked"] == 1 and info["plan_hits"] == 2, info
    assert [n for _, n in fast.last_selections] == ["cuda.ell", "cuda.ell"]
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a, b)


def test_compile_of_grad_spmm_matches_reference():
    """The SpMM transpose (``d_dense = Aᵀ·ct``) is detected too."""
    csr = random_csr(ROWS, COLS, density=0.12, seed=7)
    h = np.random.default_rng(9).standard_normal((COLS, 5)).astype(np.float32)

    def spmm_jax(val, col, row_ptr, hh):
        row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                         total_repeat_length=val.shape[0])
        return jax.ops.segment_sum(val[:, None] * hh[col], row,
                                   num_segments=ROWS)

    def spmm(val, col, row_ptr, hh):
        row = torch.repeat_interleave(torch.arange(ROWS), torch.diff(row_ptr),
                                      output_size=val.shape[0])
        out = torch.zeros((ROWS, hh.shape[1]), dtype=hh.dtype)
        return out.index_add_(0, row, val[:, None] * hh[col])

    jgrad = jax.grad(lambda *a: jnp.sum(spmm_jax(*a) ** 2), argnums=(0, 3))
    j = (jnp.asarray(csr.val), jnp.asarray(csr.col_ind),
         jnp.asarray(csr.row_ptr), jnp.asarray(h))
    jfast = jlilac.compile(jgrad)
    want = jfast(*j)
    t = tuple(torch.from_numpy(np.asarray(a)) for a in j)
    fast = lilac.compile(torch.func.grad(lambda *a: (spmm(*a) ** 2).sum(),
                                         argnums=(0, 3)),
                         mode="host", platform="cpu")
    got = fast(*t)
    assert [(m.computation, m.format) for m in fast.last_report.matches] \
        == [(m.computation, m.format) for m in jfast.last_report.matches] \
        == [("spmm_csr", "CSR"), ("spmm_csr", "COO")]
    _close(got, jgrad(*j))
    _close(got, want)


# ---------------------------------------------------------------------------
# grad-of-compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "trace"])
def test_grad_through_compiled_matches_reference(problem, mode):
    j, t = problem
    want, _ = _ref_grads(j)
    fast = lilac.compile(naive, mode=mode, platform="cpu")
    val, vec = t[0].clone().requires_grad_(), t[3].clone().requires_grad_()
    (fast(val, t[1], t[2], vec) ** 2).sum().backward()
    _close((val.grad, vec.grad), want)
    got = torch.func.grad(lambda v, x: (fast(v, t[1], t[2], x) ** 2).sum(),
                          argnums=(0, 1))(t[0], t[3])
    _close(got, want)


@pytest.mark.parametrize("name", SPMV_HARNESSES)
def test_every_spmv_harness_carries_both_gradients(problem, name):
    """Fault 1: the marshaling harnesses repack the values outside
    autograd and the kernels' output has no history; through their
    ``vjp`` clauses ``val.grad`` and ``vec.grad`` equal naive autograd's
    (``val.grad`` was None under ``torch.ell`` and ``cuda.ell``)."""
    _, t = problem
    fast = lilac.compile(naive, mode="host", platform="cpu", policy=name)
    val, vec = t[0].clone().requires_grad_(), t[3].clone().requires_grad_()
    (fast(val, t[1], t[2], vec) ** 2).sum().backward()
    assert [n for _, n in fast.last_selections] == [name]
    rv, rx = t[0].clone().requires_grad_(), t[3].clone().requires_grad_()
    loss(rv, t[1], t[2], rx).backward()
    assert val.grad is not None and vec.grad is not None
    _close((val.grad, vec.grad), (rv.grad, rx.grad))
    got = torch.func.grad(lambda v, x: (fast(v, t[1], t[2], x) ** 2).sum(),
                          argnums=(0, 1))(t[0], t[3])
    _close(got, (rv.grad, rx.grad))
    assert fast.resilience_info()["containment"]["contained_exceptions"] == 0


def _spmm(val, col, row_ptr, h):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    out = torch.zeros((rows, h.shape[1]), dtype=h.dtype)
    return out.index_add_(0, row, val[:, None] * h[col])


@pytest.mark.parametrize("name", ["torch.segment", "torch.bcsr", "cuda.bcsr"])
def test_every_spmm_harness_carries_both_gradients(problem, name,
                                                   monkeypatch):
    """``spmm_csr_bwd`` (the marshaling harnesses' clause), taken in
    chunks of 64 gathered values here, against naive autograd."""
    monkeypatch.setattr(H, "SPMM_BWD_CHUNK", 64)
    _, t = problem
    h = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (COLS, 5)).astype(np.float32))
    fast = lilac.compile(_spmm, mode="host", platform="cpu", policy=name)
    val, hh = t[0].clone().requires_grad_(), h.clone().requires_grad_()
    (fast(val, t[1], t[2], hh) ** 2).sum().backward()
    assert [n for _, n in fast.last_selections] == [name]
    want = torch.func.grad(lambda v, x: (_spmm(v, t[1], t[2], x) ** 2).sum(),
                           argnums=(0, 1))(t[0], h)
    _close((val.grad, hh.grad), want)
    got = torch.func.grad(lambda v, x: (fast(v, t[1], t[2], x) ** 2).sum(),
                          argnums=(0, 1))(t[0], h)
    _close(got, want)


def test_grad_calls_never_bake_and_say_why(problem):
    _, t = problem
    fast = lilac.compile(naive, mode="host", platform="cpu",
                         policy="torch.ell")
    for _ in range(2):
        val = t[0].clone().requires_grad_()
        fast(val, t[1], t[2], t[3]).sum().backward()
    info = fast.plan_info()
    assert info["baked"] == 0 and info["plan_hits"] == 0
    assert "carries gradients" in info["bake_errors"][0]
    fast(*t)
    fast(*t)                      # the same signature without grad bakes
    assert fast.plan_info()["plan_hits"] == 1
    got = torch.func.grad(lambda v: fast(v, t[1], t[2], t[3]).sum())(t[0])
    assert fast.plan_info()["plan_hits"] == 1
    assert torch.allclose(got, torch.func.grad(
        lambda v: naive(v, t[1], t[2], t[3]).sum())(t[0]), **TOL)


def test_grad_matches_oracle_property():
    """Hypothesis: for any random sparse problem, grad through the
    compiled call equals the uncompiled program's (atol = rtol = 1e-4, the
    reference's)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @st.composite
    def prob(draw):
        return (draw(st.integers(4, 32)), draw(st.integers(4, 32)),
                draw(st.floats(0.05, 0.5)), draw(st.integers(0, 2 ** 16)))

    @settings(max_examples=10, deadline=None)
    @given(prob())
    def check(p):
        rows, cols, density, seed = p
        csr = csr_from_dense(random_dense_sparse(rows, cols, density, seed))
        if csr.nnz == 0:
            return
        val, col, ptr = (torch.from_numpy(np.asarray(a)) for a in
                         (csr.val, csr.col_ind, csr.row_ptr))
        vec = torch.from_numpy(np.random.default_rng(seed + 1)
                               .standard_normal(cols).astype(np.float32))
        fast = lilac.compile(naive, mode="host", platform="cpu",
                             policy="cuda.ell")
        gf = torch.func.grad(lambda v, x: (fast(v, col, ptr, x) ** 2).sum(),
                             argnums=(0, 1))(val, vec)
        gr = torch.func.grad(lambda v, x: (naive(v, col, ptr, x) ** 2).sum(),
                             argnums=(0, 1))(val, vec)
        _close(gf, gr, atol=1e-4, rtol=1e-4)

    check()


# ---------------------------------------------------------------------------
# vjp clauses, epilogues, missing gradients
# ---------------------------------------------------------------------------

def _ell_inputs():
    rng = np.random.default_rng(3)
    width = 6
    val = rng.standard_normal((ROWS, width)).astype(np.float32)
    col = rng.integers(0, COLS, (ROWS, width)).astype(np.int32)
    vec = rng.standard_normal(COLS).astype(np.float32)
    bias = rng.standard_normal(ROWS).astype(np.float32)
    return val, col, vec, bias


def test_vjp_clause_on_direct_ell_matches_reference():
    """``policy="cuda.ell"`` on the direct ELL form differentiates through
    its ``vjp spmv_ell_bwd`` clause: the port's ``HarnessCall`` is the
    output's autograd node, ``cuda.ell`` ran (the reference's test gets
    ``jnp.ell`` in its place, R3), and the gradients equal the reference's
    padded-dense oracle."""
    val, col, vec, _ = _ell_inputs()

    def naive_ell_jax(v, c, x):
        return jnp.sum(v * x[c], axis=1)

    want = jax.grad(lambda v, x: jnp.sum(naive_ell_jax(v, jnp.asarray(col), x)
                                         ** 2), argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(vec))

    def naive_ell(v, c, x):
        return torch.sum(v * x[c], dim=1)

    fast = lilac.compile(naive_ell, mode="host", platform="cpu",
                         policy="cuda.ell")
    v = torch.from_numpy(val).requires_grad_()
    x = torch.from_numpy(vec).requires_grad_()
    out = fast(v, torch.from_numpy(col), x)
    assert type(out.grad_fn).__name__ == "HarnessCallBackward"
    (out ** 2).sum().backward()
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    _close((v.grad, x.grad), want)
    # trace mode: the custom op's autograd formula, the same body
    tfast = lilac.compile(naive_ell, platform="cpu", policy="cuda.ell")
    g = torch.func.grad(lambda a, b: (tfast(a, torch.from_numpy(col), b)
                                      ** 2).sum(), argnums=(0, 1))(
        torch.from_numpy(val), torch.from_numpy(vec))
    assert [n for _, n in tfast.last_selections] == ["cuda.ell"]
    _close(g, want)


def _ell_layer(val, col, vec, bias):
    return torch.relu(torch.sum(val * vec[col], dim=1) + bias)


@pytest.mark.parametrize("mode", ["host", "trace"])
def test_epilogue_unfuses_under_grad(mode):
    """The detected relu(+bias) runs in the kernel on a plain call and
    after it under differentiation, where autograd sees it; the gradients
    of val, vec and bias equal the uncompiled layer's."""
    val, col, vec, bias = (torch.from_numpy(a) for a in _ell_inputs())
    fast = lilac.compile(_ell_layer, mode=mode, platform="cpu",
                         policy="cuda.ell")
    assert fast.last_report is None
    plain = fast(val, col, vec, bias)
    assert fast.last_report.matches[0].epilogue == "relu"
    args = [t.clone().requires_grad_() if t.is_floating_point() else t
            for t in (val, col, vec, bias)]
    out = fast(*args)
    assert torch.equal(out.detach(), plain)
    (out ** 2).sum().backward()
    ref = [t.clone().requires_grad_() if t.is_floating_point() else t
           for t in (val, col, vec, bias)]
    (_ell_layer(*ref) ** 2).sum().backward()
    for a, b in ((args[0], ref[0]), (args[2], ref[2]), (args[3], ref[3])):
        _close((a.grad,), (b.grad,))
    if mode == "trace":
        ops = [n for n in fast.graph_for(*args).graph.nodes
               if n.target is torch.ops.lilac_torch.spmv_ell.default]
        assert len(ops) == 1 and ops[0].args[6] is None    # no epilogue
        fused = [n for n in fast.graph_for(val, col, vec, bias).graph.nodes
                 if n.target is torch.ops.lilac_torch.spmv_ell.default]
        assert fused[0].args[6] == "relu"
    else:
        assert out.grad_fn.name().startswith("ClampMin")


def test_missing_gradient_raises_naming_the_key(problem):
    _, t = problem
    reg = H.HarnessRegistry()

    @lilac.vjp("forgets_a_bwd", override=True)
    def forgets_a(b, ctx, primal, ct):
        return {"iv": torch.zeros_like(b["iv"])}

    @lilac.harness("""
    HARNESS test.forgetful implements spmv_csr
      formats CSR;
      host_only;
      marshal ell = ell_pack(a, colidx, rowstr|rowidx)
          from csr_binding to ELL8;
      vjp forgets_a_bwd(a, iv);
    """, registry=reg)
    def forgetful(b, ctx, *, ell):
        return H._ell_spmv(ell.val, ell.col, ell.perm, b["iv"])

    fast = lilac.compile(naive, mode="host", platform="cpu",
                         policy="test.forgetful", registry=reg)
    val = t[0].clone().requires_grad_()
    out = fast(val, t[1], t[2], t[3])
    with pytest.raises(ValueError, match=r"no gradient for \['a'\]"):
        out.sum().backward()


def test_harness_without_clause_that_leaves_autograd_raises(problem):
    _, t = problem
    reg = H.HarnessRegistry()

    @lilac.harness("""
    HARNESS test.detached implements spmv_csr
      formats CSR;
      host_only;
    """, registry=reg)
    def detached(b, ctx):
        with torch.no_grad():
            return H._spmv_segment(b, ctx)

    fast = lilac.compile(naive, mode="host", platform="cpu",
                         policy="test.detached", registry=reg)
    val = t[0].clone().requires_grad_()
    # the ValueError is the harness's failure: containment quarantines it,
    # loudly, and with no other candidate in this registry the anchor runs
    # as the uncompiled program, gradient included
    with pytest.warns(lilac.LilacContainmentWarning,
                      match=r"test.detached.*no gradient for \['a'\]"):
        out = fast(val, t[1], t[2], t[3])
    assert fast.last_selections == []
    assert fast.resilience_info()["disabled_matches"] == 1
    out.sum().backward()
    want = torch.func.grad(lambda v: naive(v, t[1], t[2], t[3]).sum())(t[0])
    _close((val.grad,), (want,))


def test_unknown_vjp_is_a_spec_error():
    with pytest.raises(lilac.SpecError, match="unknown vjp 'nope_bwd'"):
        lilac.harness("""
        HARNESS test.typo implements spmv_csr
          vjp nope_bwd(a, iv);
        """, registry=H.HarnessRegistry())(lambda b, ctx: None)


def test_every_cuda_harness_declares_the_reference_clause():
    from repro.core.harness import REGISTRY as JREG

    lilac.register_builtins()
    from repro import lilac as _jl  # noqa: F401  (registers the Pallas blocks)

    for comp in ("spmv_csr", "spmv_ell", "spmm_csr", "moe_ffn"):
        for h in H.REGISTRY.harnesses_for(comp):
            if not h.name.startswith("cuda."):
                continue
            ref = next(r for r in JREG.harnesses_for(comp)
                       if r.name == "pallas." + h.name[5:])
            assert (h.vjp.name, h.vjp.wrt) == (ref.vjp.name, ref.vjp.wrt)


# ---------------------------------------------------------------------------
# detection under an ambient trace
# ---------------------------------------------------------------------------

def test_detection_under_ambient_grad_trace():
    """An inner compiled MoE called while ``make_fx`` traces
    ``torch.func.grad_and_value`` of a loss still detects ``moe_ffn``: its
    trace and its semantic validation run outside the ambient modes."""
    T, D, F, E, K = 32, 8, 16, 4, 1
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    x = t(rng.standard_normal((T, D)))
    gate = t(rng.random((T, K)))
    idx = torch.from_numpy((np.arange(T * K).reshape(T, K) % E)
                           .astype(np.int32))
    wg, wu = t(rng.standard_normal((E, D, F)) * .1), \
        t(rng.standard_normal((E, D, F)) * .1)
    wd = t(rng.standard_normal((E, F, D)) * .1)
    inner = lilac.compile(_moe_naive_2d, platform="cpu")

    def f(wg, wu, wd):
        return torch.mean(inner(x, gate, idx, wg, wu, wd) ** 2)

    gm = make_fx(torch.func.grad_and_value(f, argnums=(0, 1, 2)))(wg, wu, wd)
    assert [m.computation for m in inner.last_report.matches] == ["moe_ffn"]
    *g, v = torch.utils._pytree.tree_leaves(gm(wg, wu, wd))
    rg, rv = torch.func.grad_and_value(
        lambda a, b, c: torch.mean(_moe_naive_2d(x, gate, idx, a, b, c) ** 2),
        argnums=(0, 1, 2))(wg, wu, wd)
    _close(g, rg, atol=1e-6, rtol=1e-5)
    _close((v,), (rv,), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the custom ops' autograd formulas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue", [None, "relu", "silu"])
@pytest.mark.parametrize("jds", [False, True])
def test_spmv_ell_op_gradcheck(epilogue, jds):
    rng = np.random.default_rng(5)
    rows, width, cols = 12, 3, 9
    val = torch.from_numpy(rng.standard_normal((rows, width))) \
        .requires_grad_()
    col = torch.from_numpy(rng.integers(0, cols, (rows, width))
                           .astype(np.int32))
    vec = torch.from_numpy(rng.standard_normal(cols)).requires_grad_()
    bias = torch.from_numpy(rng.standard_normal(rows + 2 * jds)) \
        .requires_grad_()
    perm = torch.from_numpy(rng.permutation(rows + 2)[:rows]
                            .astype(np.int32)) if jds else None
    out_rows = rows + 2 if jds else None

    def f(v, x, b):
        return ell_ops.spmv_ell_op(v, col, x, b, perm, out_rows, epilogue, 32)

    assert torch.autograd.gradcheck(f, (val, vec, bias))


@pytest.mark.parametrize("routing", ["balanced", "skewed"])
def test_moe_ffn_op_gradcheck(routing):
    """The formula is ``moe_ffn_bwd`` at a capacity no load exceeds, so it
    is exact under skewed routing too, where every token takes experts 0
    and 1 (16 pairs each, past the reference's capacity of 8, at which
    this gradcheck fails)."""
    rng = np.random.default_rng(6)
    T, D, F, E, K = 16, 4, 6, 8, 2
    x = torch.from_numpy(rng.standard_normal((T, D))).requires_grad_()
    gate = torch.from_numpy(rng.random((T, K))).requires_grad_()
    ids = np.arange(T * K).reshape(T, K) % (E if routing == "balanced"
                                            else K)
    idx = torch.from_numpy(ids.astype(np.int32))
    ws = [torch.from_numpy(rng.standard_normal(s) * .3).requires_grad_()
          for s in ((E, D, F), (E, D, F), (E, F, D))]

    def f(x, gate, wg, wu, wd):
        return gmm_ops.moe_ffn_op(x, gate, idx, wg, wu, wd, 8)

    assert torch.autograd.gradcheck(f, (x, gate, *ws))
