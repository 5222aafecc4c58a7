"""Detection parity: the same naive SpMV, SpMM, MoE FFN, dot product,
GEMV or loop written in torch and in JAX must give the same computation,
variant, format, fused epilogue and binding — each binding key naming the
same function argument (or the same integer) — from the port's FX-graph
detector and the JAX package's jaxpr detector.  The torch twin of the
reference's ``fori_loop`` is the loop ``make_fx`` unrolls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import tab3_detection as T3
from repro import lilac as jlilac
from repro.core import detect as JD
from repro.models import layers as jlayers
from repro_torch import lilac
from repro_torch.core import detect as TD
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine
from repro_torch.models import layers as tlayers

ROWS, COLS, NNZ, W, N = 16, 8, 40, 8, 6


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """The stores of the compiling tests in this test's directory, no
    ambient chaos plan, no shadow checks."""
    for name, file in (("AUTOTUNE", "autotune"), ("PLAN", "plans"),
                       ("QUARANTINE", "quarantine")):
        monkeypatch.setenv(f"LILAC_TORCH_{name}_CACHE",
                           str(tmp_path / f"{file}.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()


def _arrays():
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.integers(0, NNZ + 1, ROWS - 1))
    return dict(
        val=rng.standard_normal(NNZ).astype(np.float32),
        col=rng.integers(0, COLS, NNZ).astype(np.int32),
        row=np.sort(rng.integers(0, ROWS, NNZ)).astype(np.int32),
        row_ptr=np.concatenate([[0], cuts, [NNZ]]).astype(np.int32),
        vec=rng.standard_normal(COLS).astype(np.float32),
        val2=rng.standard_normal((ROWS, W)).astype(np.float32),
        col2=rng.integers(0, COLS, (ROWS, W)).astype(np.int32),
        perm=rng.permutation(ROWS).astype(np.int32),
        bias=rng.standard_normal(ROWS).astype(np.float32),
        dmat=rng.standard_normal((COLS, N)).astype(np.float32),
        bias_n=rng.standard_normal(N).astype(np.float32),
    )


# -- the two spellings of each program ---------------------------------------

def csr_jax(val, col, row_ptr, v):          # examples/quickstart.py
    row = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                     total_repeat_length=val.shape[0])
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def csr_torch(val, col, row_ptr, v):
    row = torch.repeat_interleave(torch.arange(ROWS), torch.diff(row_ptr),
                                  output_size=val.shape[0])
    return torch.zeros(ROWS).index_add_(0, row, val * v[col])


def csr_search_jax(val, col, row_ptr, v):
    row = jnp.searchsorted(row_ptr, jnp.arange(NNZ, dtype=jnp.int32),
                           side="right").astype(jnp.int32) - 1
    return jax.ops.segment_sum(val * v[col], row, num_segments=ROWS)


def csr_search_torch(val, col, row_ptr, v):
    row = torch.searchsorted(row_ptr, torch.arange(NNZ, dtype=torch.int32),
                             right=True) - 1
    return torch.zeros(ROWS).scatter_add_(0, row.long(), val * v[col.long()])


def csr_relu_jax(val, col, row_ptr, v, bias):
    return jax.nn.relu(csr_jax(val, col, row_ptr, v) + bias)


def csr_relu_torch(val, col, row_ptr, v, bias):
    return torch.relu(csr_torch(val, col, row_ptr, v) + bias)


def coo_jax(val, row, col, v):
    return jax.ops.segment_sum(v[col] * val, row, num_segments=ROWS)


def coo_torch(val, row, col, v):
    out = torch.zeros(ROWS)
    out.index_put_((row,), v[col] * val, accumulate=True)
    return out


def ell_jax(val2, col2, vec):
    return jnp.sum(val2 * vec[col2], axis=1)


def ell_torch(val2, col2, vec):
    return (val2 * vec[col2]).sum(dim=1)


def ell_relu_bias_jax(val2, col2, vec, bias):
    return jax.nn.relu(jnp.sum(val2 * vec[col2], axis=1) + bias)


def ell_relu_bias_torch(val2, col2, vec, bias):
    return torch.relu((val2 * vec[col2]).sum(dim=1) + bias)


def ell_silu_jax(val2, col2, vec):
    return jax.nn.silu(jnp.sum(val2 * vec[col2], axis=1))


def ell_silu_torch(val2, col2, vec):
    s = torch.sum(val2 * vec[col2], dim=1)
    return s * torch.sigmoid(s)


def jds_jax(val2, col2, perm, vec):
    acc = jnp.sum(val2 * vec[col2], axis=1)
    return jnp.zeros(ROWS, acc.dtype).at[perm].set(acc)


def jds_torch(val2, col2, perm, vec):
    acc = (val2 * vec[col2]).sum(1)
    out = torch.zeros(ROWS)
    out[perm] = acc
    return out


def spmm_jax(val, col, row_ptr, dmat):     # benchmarks/tab3_detection.py:70
    r = jnp.repeat(jnp.arange(ROWS, dtype=jnp.int32), jnp.diff(row_ptr),
                   total_repeat_length=NNZ)
    return jax.ops.segment_sum(val[:, None] * dmat[col], r,
                               num_segments=ROWS)


def spmm_torch(val, col, row_ptr, dmat):
    r = torch.repeat_interleave(torch.arange(ROWS), torch.diff(row_ptr),
                                output_size=NNZ)
    return torch.zeros(ROWS, dmat.shape[1]).index_add_(
        0, r, val[:, None] * dmat[col])


def spmm_coo_jax(val, row, col, dmat):
    return jax.ops.segment_sum(dmat[col] * val[:, None], row,
                               num_segments=ROWS)


def spmm_coo_torch(val, row, col, dmat):
    upd = dmat.index_select(0, col) * val.unsqueeze(1)
    return torch.zeros(ROWS, dmat.shape[1]).scatter_add_(
        0, row.long()[:, None].expand(-1, dmat.shape[1]), upd)


def spmm_relu_jax(val, col, row_ptr, dmat, bias_n):
    return jax.nn.relu(spmm_jax(val, col, row_ptr, dmat) + bias_n)


def spmm_relu_torch(val, col, row_ptr, dmat, bias_n):
    return torch.relu(spmm_torch(val, col, row_ptr, dmat) + bias_n)


CASES = [
    (csr_jax, csr_torch, ("val", "col", "row_ptr", "vec")),
    (csr_search_jax, csr_search_torch, ("val", "col", "row_ptr", "vec")),
    (csr_relu_jax, csr_relu_torch, ("val", "col", "row_ptr", "vec", "bias")),
    (coo_jax, coo_torch, ("val", "row", "col", "vec")),
    (ell_jax, ell_torch, ("val2", "col2", "vec")),
    (ell_relu_bias_jax, ell_relu_bias_torch, ("val2", "col2", "vec", "bias")),
    (ell_silu_jax, ell_silu_torch, ("val2", "col2", "vec")),
    (jds_jax, jds_torch, ("val2", "col2", "perm", "vec")),
    (spmm_jax, spmm_torch, ("val", "col", "row_ptr", "dmat")),
    (spmm_coo_jax, spmm_coo_torch, ("val", "row", "col", "dmat")),
]


def _summary(matches, inputs):
    """Per match: (computation, format, epilogue, {key: arg index | int})."""
    out = []
    for m in matches:
        b = {}
        for k, v in m.binding.items():
            if isinstance(v, (int, float)):
                b[k] = ("num", v)
            else:
                b[k] = ("arg", inputs.index(v)) if v in inputs else "derived"
        out.append((m.computation, m.format, m.epilogue, b))
    return out


@pytest.mark.parametrize("fj,ft,names", CASES,
                         ids=[c[1].__name__ for c in CASES])
def test_detection_matches_reference(fj, ft, names):
    arrs = _arrays()
    jargs = [jnp.asarray(arrs[n]) for n in names]
    targs = [torch.from_numpy(arrs[n]) for n in names]
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(fj)(*jargs))
    want = _summary(JD.Detector().detect(ncj, normalize=False).matches,
                    list(ncj.jaxpr.invars))
    gm = TD.trace(ft, targs)
    got = _summary(TD.Detector().detect(gm).matches,
                   [n for n in gm.graph.nodes if n.op == "placeholder"])
    assert len(want) == 1
    assert got == want
    # the traced graph computes what the program computes
    torch.testing.assert_close(gm(*targs), ft(*targs))


def test_no_match_without_the_skeleton():
    """Negative controls: a scatter-add onto a non-zero operand, a
    gathered product that is never reduced, a padded row sum whose index
    is broadcast, and a scatter-add of one scalar weight are not SpMVs.
    The broadcast one is a dense matrix times one gathered vector: the
    GEMV matcher takes it."""
    arrs = _arrays()
    val, row, col, vec = (torch.from_numpy(arrs[n])
                          for n in ("val", "row", "col", "vec"))

    def accumulate_into(val, row, col, vec):
        return torch.ones(ROWS).index_add_(0, row, val * vec[col])

    def unreduced(val, col, vec):
        return val * vec[col]

    def broadcast_index(val2, col, vec):
        return (val2 * vec[col[:W]]).sum(dim=1)

    def scalar_weight(val, row, col, vec):
        return torch.zeros(ROWS).index_add_(0, row, val[0] * vec[col])

    det = TD.Detector()
    assert det.detect_fn(accumulate_into, val, row, col, vec).matches == []
    assert det.detect_fn(unreduced, val, col, vec).matches == []
    val2 = torch.from_numpy(arrs["val2"])
    assert [(m.computation, m.format) for m in det.detect_fn(
        broadcast_index, val2, col, vec).matches] == [("gemv", "GEMV")]
    assert det.detect_fn(scalar_weight, val, row, col, vec).matches == []


def test_row_expansion_is_validated_not_assumed():
    """A (rows+1,) integer input that feeds the row ids but is not a row
    pointer (here: row ids taken modulo) stays COO."""
    arrs = _arrays()
    val, col, row_ptr, vec = (torch.from_numpy(arrs[n])
                              for n in ("val", "col", "row_ptr", "vec"))

    def not_csr(val, col, row_ptr, v):
        row = (torch.arange(NNZ) + row_ptr[0]) % ROWS
        return torch.zeros(ROWS).index_add_(0, row, val * v[col])

    (m,) = TD.Detector().detect_fn(not_csr, val, col, row_ptr, vec).matches
    assert m.format == "COO"
    assert "rowidx" in m.binding and "rowstr" not in m.binding


@pytest.mark.parametrize("error,verdict", [
    (RuntimeError("shape '[240]' is invalid for input of size 7"), "COO"),
    (IndexError("index 9 is out of bounds"), "COO"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "raises"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "raises"),
])
def test_row_expansion_validation_rejects_or_raises(monkeypatch, error,
                                                    verdict):
    """A row-expansion subgraph that fails to evaluate on a trial row_ptr
    is not CSR; a fault of the card is no verdict, and raises."""
    arrs = _arrays()
    args = [torch.from_numpy(arrs[n]) for n in ("val", "col", "row_ptr", "vec")]

    def fail(self, out, leaf_values):
        raise error

    monkeypatch.setattr(TD.Ctx, "eval_subgraph", fail)
    if verdict == "raises":
        with pytest.raises(type(error)):
            TD.Detector().detect_fn(csr_torch, *args)
        return
    (m,) = TD.Detector().detect_fn(csr_torch, *args).matches
    assert m.format == verdict and "rowstr" not in m.binding


def test_spmm_fused_epilogue_binds_the_column_bias():
    """relu(A @ H + b) with b of shape (N,): both detectors fuse the
    epilogue.  JAX binds the bias after its broadcast to (rows, N) (its
    kernel then applies it unfused); the port binds b itself, which its
    kernel takes as a column bias.  Everything else binds alike."""
    names = ("val", "col", "row_ptr", "dmat", "bias_n")
    arrs = _arrays()
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(spmm_relu_jax)(
        *[jnp.asarray(arrs[n]) for n in names]))
    (want,) = _summary(JD.Detector().detect(ncj, normalize=False).matches,
                       list(ncj.jaxpr.invars))
    targs = [torch.from_numpy(arrs[n]) for n in names]
    gm = TD.trace(spmm_relu_torch, targs)
    (got,) = _summary(TD.Detector().detect(gm).matches,
                      [n for n in gm.graph.nodes if n.op == "placeholder"])
    assert got[:3] == want[:3] == ("spmm_csr", "CSR", "relu")
    assert want[3].pop("bias") == "derived"
    assert got[3].pop("bias") == ("arg", 4)
    assert got[3] == want[3]


def test_spmm_needs_its_scatter_skeleton():
    """Negative controls for SpMM: scaled row windows that are never
    scattered, a scatter-add onto a non-zero operand, and a 1-D weight
    that broadcasts along the columns instead of scaling rows."""
    arrs = _arrays()
    val, row, col, dmat = (torch.from_numpy(arrs[n])
                           for n in ("val", "row", "col", "dmat"))

    def unscattered(val, col, dmat):
        return val[:, None] * dmat[col]

    def accumulate_into(val, row, col, dmat):
        return torch.ones(ROWS, N).index_add_(0, row, val[:, None] * dmat[col])

    def column_weight(val, row, col, dmat):
        return torch.zeros(ROWS, N).index_add_(0, row, val[:N] * dmat[col])

    det = TD.Detector()
    assert det.detect_fn(unscattered, val, col, dmat).matches == []
    assert det.detect_fn(accumulate_into, val, row, col, dmat).matches == []
    assert det.detect_fn(column_weight, val, row, col, dmat).matches == []


T_, D_, F_, E_, K_ = 12, 16, 8, 4, 2


def _moe_arrays():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((T_, D_)).astype(np.float32),
            rng.random((T_, K_)).astype(np.float32),
            rng.integers(0, E_, (T_, K_)).astype(np.int32),
            rng.standard_normal((E_, D_, F_)).astype(np.float32),
            rng.standard_normal((E_, D_, F_)).astype(np.float32),
            rng.standard_normal((E_, F_, D_)).astype(np.float32)]


def test_moe_detection_matches_reference():
    arrs = _moe_arrays()
    jargs = [jnp.asarray(a) for a in arrs]
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(jlayers._moe_naive_2d)(
        *jargs))
    want = _summary(JD.Detector().detect(ncj, normalize=False).matches,
                    list(ncj.jaxpr.invars))
    targs = [torch.from_numpy(a) for a in arrs]
    gm = TD.trace(tlayers._moe_naive_2d, targs)
    got = _summary(TD.Detector().detect(gm).matches,
                   [n for n in gm.graph.nodes if n.op == "placeholder"])
    assert got == want
    assert got[0][:2] == ("moe_ffn", "MOE")
    torch.testing.assert_close(gm(*targs), tlayers._moe_naive_2d(*targs))


def _moe_bad_combine(x, gate, idx, wg, wu, wd):
    onehot = torch.nn.functional.one_hot(idx.long(), E_).to(x.dtype)
    combine = torch.einsum("tke,tk->te", onehot, gate * gate)
    h = torch.nn.functional.silu(torch.einsum("td,edf->etf", x, wg)) \
        * torch.einsum("td,edf->etf", x, wu)
    y = torch.einsum("etf,efd->etd", h, wd)
    return torch.einsum("te,etd->td", combine, y)


def _moe_shifted_onehot(x, gate, idx, wg, wu, wd):
    return tlayers._moe_naive_2d(x, gate, (idx + 1) % E_, wg, wu, wd)


def _moe_no_silu(x, gate, idx, wg, wu, wd):
    onehot = torch.nn.functional.one_hot(idx.long(), E_).to(x.dtype)
    combine = torch.einsum("tke,tk->te", onehot, gate)
    h = torch.einsum("td,edf->etf", x, wg) * torch.einsum("td,edf->etf", x, wu)
    return torch.einsum("te,etd->td", combine,
                        torch.einsum("etf,efd->etd", h, wd))


@pytest.mark.parametrize("fn", [_moe_bad_combine, _moe_shifted_onehot,
                                _moe_no_silu])
def test_moe_rejects_what_is_not_a_topk_dispatch_ffn(fn):
    """A combine that is not a top-k one-hot of (idx, gate) fails the
    executed validation; an FFN without its gated silu fails the
    structure."""
    targs = [torch.from_numpy(a) for a in _moe_arrays()]
    assert TD.Detector().detect_fn(fn, *targs).matches == []


@pytest.mark.parametrize("error,verdict", [
    (RuntimeError("shape '[12, 4]' is invalid for input of size 7"), "none"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "raises"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "raises"),
])
def test_onehot_validation_rejects_or_raises(monkeypatch, error, verdict):
    """A combine subgraph that fails to evaluate on trial (idx, gate) is no
    MoE dispatch; a fault of the card is no verdict, and raises."""
    targs = [torch.from_numpy(a) for a in _moe_arrays()]
    gm = TD.trace(tlayers._moe_naive_2d, targs)

    def fail(self, out, leaf_values):
        raise error

    monkeypatch.setattr(TD.Ctx, "eval_subgraph", fail)
    if verdict == "raises":
        with pytest.raises(type(error)):
            TD.Detector().detect(gm)
        return
    assert TD.Detector().detect(gm).matches == []


# -- dot, gemv and loops (the reference's test_detect.py) ---------------------

def _report(fj, ft, jargs, targs):
    """(reference summary, port summary) of the same program, each match
    with its variant."""
    ncj = JD.normalize_closed_jaxpr(jax.make_jaxpr(fj)(*jargs))
    jm = JD.Detector().detect(ncj, normalize=False).matches
    gm = TD.trace(ft, targs)
    tm = TD.Detector().detect(gm).matches
    want = [s + (m.variant,) for s, m in zip(
        _summary(jm, list(ncj.jaxpr.invars)), jm)]
    got = [s + (m.variant,) for s, m in zip(
        _summary(tm, [n for n in gm.graph.nodes if n.op == "placeholder"]),
        tm)]
    return want, got


def coo_loop_jax(val, row, col, vec):       # test_detect.py: fori_loop
    def body(j, out):
        return out.at[row[j]].add(val[j] * vec[col[j]])
    return jax.lax.fori_loop(0, val.shape[0], body, jnp.zeros(ROWS))


def coo_loop_get_add_put(val, row, col, vec):
    out = torch.zeros(ROWS)
    for k in range(val.shape[0]):
        out[row[k:k + 1]] += val[k] * vec[col[k:k + 1]]
    return out


def coo_loop_accumulate(val, row, col, vec):
    out = torch.zeros(ROWS)
    for k in range(val.shape[0]):
        out.index_put_((row[k:k + 1],), val[k:k + 1] * vec[col[k:k + 1]],
                       accumulate=True)
    return out


def coo_loop_index_add(val, row, col, vec):
    out = torch.zeros(ROWS)
    for k in range(val.shape[0]):
        out.index_add_(0, row[k, None],
                       vec.index_select(0, col[k, None]) * val[k])
    return out


@pytest.mark.parametrize("ft", [coo_loop_get_add_put, coo_loop_accumulate,
                                coo_loop_index_add],
                         ids=lambda f: f.__name__)
def test_loop_skeleton_coo(ft):
    """The paper's primary case: the COO accumulation loop, unrolled by
    ``make_fx`` in each form it takes, is one ``variant="loop"`` COO SpMV
    of nnz = n, as the reference's fori_loop is; compiled, it returns the
    reference's compiled output."""
    arrs = _arrays()
    names = ("val", "row", "col", "vec")
    jargs = [jnp.asarray(arrs[n]) for n in names]
    targs = [torch.from_numpy(arrs[n]) for n in names]
    want, got = _report(coo_loop_jax, ft, jargs, targs)
    assert got == want
    assert [(c, f, v) for c, f, _, _, v in got] == [("spmv_csr", "COO",
                                                     "loop")]
    assert got[0][3]["nnz"] == ("num", NNZ)
    ref = np.asarray(jlilac.compile(coo_loop_jax, mode="host")(*jargs))
    for mode in ("host", "trace"):
        fast = lilac.compile(ft, mode=mode, platform="cpu")
        out = fast(*targs)
        assert [(m.variant, m.format) for m in fast.last_report.matches] \
            == [("loop", "COO")]
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def dot_loop_jax(a, b):                      # test_detect.py: fori_loop
    return jax.lax.fori_loop(0, a.shape[0], lambda i, acc: acc + a[i] * b[i],
                             jnp.float32(0))


def dot_loop_torch(a, b):
    acc = torch.zeros(())
    for k in range(a.shape[0]):
        acc = acc + a[k] * b[k]
    return acc


def test_loop_skeleton_dot():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal(COLS).astype(np.float32) for _ in range(2))
    want, got = _report(dot_loop_jax, dot_loop_torch,
                        [jnp.asarray(a), jnp.asarray(b)],
                        [torch.from_numpy(a), torch.from_numpy(b)])
    assert got == want
    assert [(c, f, v) for c, f, _, _, v in got] == [("dotproduct", "DOT",
                                                     "loop")]
    ref = float(jlilac.compile(dot_loop_jax, mode="host")(
        jnp.asarray(a), jnp.asarray(b)))
    fast = lilac.compile(dot_loop_torch, mode="host", platform="cpu")
    assert abs(float(fast(torch.from_numpy(a), torch.from_numpy(b))) - ref) \
        <= 1e-5 * max(1.0, abs(ref))
    assert [n for _, n in fast.last_selections] == ["torch.dot"]


@pytest.mark.parametrize("fj,ft", [
    (lambda a, b: jnp.sum(a * b), lambda a, b: torch.sum(a * b)),
    (lambda a, b: jnp.dot(a, b), lambda a, b: a @ b),
    (lambda a, b: (a * b).sum(), lambda a, b: (a * b).sum()),
], ids=["sum_of_product", "dot", "method_sum"])
def test_dot_vectorized_and_language_invariance(fj, ft):
    """Fig. 11: different surface syntax, the same detection."""
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal(COLS).astype(np.float32) for _ in range(2))
    want, got = _report(fj, ft, [jnp.asarray(a), jnp.asarray(b)],
                        [torch.from_numpy(a), torch.from_numpy(b)])
    assert got == want
    assert [(c, f, v) for c, f, _, _, v in got] == [("dotproduct", "DOT",
                                                     "vectorized")]


@pytest.mark.parametrize("ft", [lambda m, v: m @ v,
                                lambda m, v: (m * v).sum(dim=1)],
                         ids=["mv", "row_sum_of_broadcast"])
def test_gemv(ft):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((ROWS, COLS)).astype(np.float32)
    v = rng.standard_normal(COLS).astype(np.float32)
    want, got = _report(lambda m, v: m @ v, ft,
                        [jnp.asarray(m), jnp.asarray(v)],
                        [torch.from_numpy(m), torch.from_numpy(v)])
    assert got == want
    assert [(c, f, v) for c, f, _, _, v in got] == [("gemv", "GEMV",
                                                     "vectorized")]
    fast = lilac.compile(ft, mode="host", platform="cpu")
    tm, tv = torch.from_numpy(m), torch.from_numpy(v)
    torch.testing.assert_close(fast(tm, tv), tm @ tv)


def two_dots_and_spmv_jax(val, row, col, p, r_):
    q = jax.ops.segment_sum(val * p[col], row, num_segments=ROWS)
    return jnp.sum(r_ * r_) / jnp.sum(jnp.pad(p, (0, ROWS - COLS)) * q)


def two_dots_and_spmv_torch(val, row, col, p, r_):
    q = torch.zeros(ROWS).index_add_(0, row, val * p[col])
    return torch.sum(r_ * r_) / torch.sum(
        torch.nn.functional.pad(p, (0, ROWS - COLS)) * q)


def test_multiple_matches_in_one_program():
    """A CG-like step: two dots and one SpMV, all detected, and the
    compiled step gives the program's value."""
    arrs = _arrays()
    rr = np.random.default_rng(6).standard_normal(ROWS).astype(np.float32)
    names = ("val", "row", "col", "vec")
    jargs = [jnp.asarray(arrs[n]) for n in names] + [jnp.asarray(rr)]
    targs = [torch.from_numpy(arrs[n]) for n in names] + [torch.from_numpy(rr)]
    want, got = _report(two_dots_and_spmv_jax, two_dots_and_spmv_torch,
                        jargs, targs)
    assert sorted(g[0] for g in got) == sorted(w[0] for w in want) \
        == ["dotproduct", "dotproduct", "spmv_csr"]
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    fast = lilac.compile(two_dots_and_spmv_torch, mode="host",
                         platform="cpu")
    torch.testing.assert_close(fast(*targs), two_dots_and_spmv_torch(*targs))


def test_negative_softmax_attention():
    t = torch.ones(8, 4)
    r = TD.Detector().detect_fn(
        lambda q, k, v: torch.softmax(q @ k.T, dim=-1) @ v, t, t, t)
    assert all(m.computation == "gemv" for m in r.matches)
    assert not any("spmv" in m.computation for m in r.matches)


def test_a_loop_over_python_int_ids_is_no_coo_matrix():
    """``out[int(row[k])] += ...`` reads each id as a Python int (as
    ``out[row[k]]`` does: a 0-d tensor index is an integer index): the
    traced graph holds the ids as constants, and no row array is read, so
    it must not match; neither may a loop that stops short of the arrays'
    length."""
    arrs = _arrays()
    names = ("val", "row", "col", "vec")
    targs = [torch.from_numpy(arrs[n]) for n in names]
    rows, cols = [int(r) for r in targs[1]], [int(c) for c in targs[2]]

    def int_ids(val, row, col, vec):
        out = torch.zeros(ROWS)
        for k in range(val.shape[0]):
            out[rows[k]] += val[k] * vec[cols[k]]
        return out

    def short(val, row, col, vec):
        out = torch.zeros(ROWS)
        for k in range(val.shape[0] - 1):
            out[row[k:k + 1]] += val[k] * vec[col[k:k + 1]]
        return out

    det = TD.Detector()
    assert det.detect_fn(int_ids, *targs).matches == []
    assert not any(m.variant == "loop"
                   for m in det.detect_fn(short, *targs).matches)
    fast = lilac.compile(int_ids, mode="host", platform="cpu")
    torch.testing.assert_close(fast(*targs), int_ids(*targs))


# -- the programs of benchmarks/tab3_detection.py ------------------------------

def _tab3_torch():
    R, C, Z = T3.ROWS, T3.COLS, T3.NNZ

    def rows_of(row_ptr):
        return torch.repeat_interleave(torch.arange(R), torch.diff(row_ptr),
                                       output_size=Z)

    def coo_loop(val, col, row, vec):
        out = torch.zeros(R)
        for k in range(Z):
            out[row[k:k + 1]] += val[k] * vec[col[k:k + 1]]
        return out

    def jds(val2, col2, perm, vec):
        acc = (val2 * vec[col2]).sum(1)
        out = torch.zeros(R)
        out[perm] = acc
        return out

    def dot_loop(a, b):
        acc = torch.zeros(())
        for k in range(C):
            acc = acc + a[k] * b[k]
        return acc

    def layernorm(x):
        mu = x.mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False)
                                     + 1e-5)

    return {
        "CSR/repeat-idiom (C-style)": lambda val, col, row_ptr, vec:
            torch.zeros(R).index_add_(0, rows_of(row_ptr), val * vec[col]),
        "CSR/searchsorted (C++-style)": lambda val, col, row_ptr, vec:
            torch.zeros(R).index_add_(
                0, torch.searchsorted(row_ptr, torch.arange(Z, dtype=torch.int32),
                                      right=True) - 1, val * vec[col]),
        "CSR/commuted (FORTRAN-style)": lambda val, col, row_ptr, vec:
            torch.zeros(R).index_add_(0, rows_of(row_ptr), vec[col] * val),
        "COO/vectorized": lambda val, col, row, vec:
            torch.zeros(R).index_add_(0, row, val * vec[col]),
        "COO/loop": coo_loop,
        "ELL/padded": lambda val2, col2, vec: (val2 * vec[col2]).sum(dim=1),
        "JDS/permuted (Parboil)": jds,
        "dot/vectorized": lambda a, b: torch.sum(a * b),
        "dot/loop": dot_loop,
        "gemv/dense": lambda m, v: m @ v,
        "SpMM/csr-x-dense": lambda val, col, row_ptr, dmat:
            torch.zeros(R, dmat.shape[1]).index_add_(
                0, rows_of(row_ptr), val[:, None] * dmat[col]),
        "NEG softmax-attention": lambda q, k: torch.softmax(q @ k.T, dim=-1),
        "NEG layernorm": layernorm,
    }


TAB3 = {name: (fj, args, want) for name, fj, args, want in T3._variants()}


@pytest.mark.parametrize("name", list(TAB3))
def test_tab3_programs_match_the_reference(name):
    """Each program of the reference's Table 3 benchmark, written in
    torch, gives the reference's computations, variants and formats (a
    negative control: no sparse match in either)."""
    fj, jargs, want_fmt = TAB3[name]
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    want, got = _report(fj, _tab3_torch()[name], list(jargs), targs)
    if want_fmt is None:
        assert not any(g[0].startswith("spmv") or g[0] == "moe_ffn"
                       for g in got + want)
        return
    assert [(c, f, v) for c, f, _, _, v in got] \
        == [(c, f, v) for c, f, _, _, v in want]
    assert want_fmt in [f for _, f, _, _, _ in got]
