"""The CUDA kernels on the card (ELL SpMV K1 in its staged and direct
bodies and K2, BCSR SpMM K3 in its wide and narrow bodies over packed
tiles, grouped matmul K4 in its bf16 and f32 bodies), against their plain
torch versions, with the edges of K1's direct body and K4's f32 body
(widths off their 16-byte steps, unaligned operands, the staged prefix,
inf under padding, zero tail rows); every declared ``tune`` value of K1
(``rows_per_slab``) and K4 (``tm``); the custom ops captured in a CUDA
graph; trace mode and the autotuner on the card; gradients through every
``cuda.*`` harness (their ``vjp`` clauses) and through the custom ops'
autograd formulas against plain autograd, ``torch.func.grad`` of a
compiled call and of a compiled gradient; a batch of vectors (the
custom ops' ``torch.func.vmap`` rules): K1's two bodies and K2 at B = 1, 3
and 8 against B solo launches bit for bit, K3 with the vectors as its
operand's columns, K4's rule against the loop; plans under transforms
(a vmapped call's batched plan replaying K1 staged, K2, K3 narrow and K4
bit for bit as the unplanned call computes, and K4's gradient-carrying
batched plan run eagerly); and serving: K4 under
``moe_ffn`` at a decode step's shapes, the compiled decode inside the
engine across re-buckets and slot moves teacher-forced against the
uncompiled decode, and a decode plan on a cache at a new address.

Every test is marked ``gpu`` and skips where no CUDA card is present.  This
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import lilac
from repro_torch.kernels.bsr_spmm import kernel as K3
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.common import apply_epilogue_inregister
from repro_torch.kernels.bsr_spmm import ref as R3
from repro_torch.kernels.moe_gmm import kernel as K4
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as R4
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.kernels.spmv_ell import ref as R
from repro_torch.models import layers as tlayers
from repro_torch.sparse import convert as tconvert
from repro_torch.sparse import formats as tf
from repro_torch.sparse import random as trandom
from repro_torch.core import faults
from repro_torch.core.resilience import reset_shared_quarantine

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # bf16 storage, f32 accumulation


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    """The autotuner's store in this test's directory (this file runs with
    --noconftest on the card)."""
    # containment's store in this test's directory, no ambient chaos plan
    # and no shadow checks: a quarantine must not outlive its test
    monkeypatch.setenv("LILAC_TORCH_QUARANTINE_CACHE",
                       str(tmp_path / "quarantine.json"))
    for k in ("LILAC_TORCH_FAULTS", "LILAC_TORCH_FAULTS_SEED",
              "LILAC_TORCH_SHADOW_RATE"):
        monkeypatch.delenv(k, raising=False)
    faults.load_env()
    reset_shared_quarantine()
    from repro_torch.core.harness import REGISTRY

    monkeypatch.setenv("LILAC_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("LILAC_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    REGISTRY.reset_autotuner()
    yield
    REGISTRY.reset_autotuner()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ell(cuda, dtype):
    csr = trandom.random_csr(777, 3000, 0.02, seed=9, skew=1.0)
    ell = tf.ell_from_csr(csr, lane=128)
    rng = np.random.default_rng(1)
    vec = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(777).astype(np.float32))
    return (ell.val.to(cuda, dtype), ell.col.to(cuda), ell.perm.to(cuda),
            vec.to(cuda, dtype), bias.to(cuda))


EPILOGUES = [(None, False, False), ("relu", True, False),
             ("silu", False, True), ("none", True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue,with_bias,with_perm", EPILOGUES)
def test_resident_kernel_matches_plain(cuda, dtype, epilogue, with_bias,
                                       with_perm):
    val, col, perm, vec, bias = _ell(cuda, dtype)
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    before = K.LAUNCHES["spmv_ell"]
    got = K.spmv_ell_cuda(val, col, vec, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell"] == before + 1
    torch.testing.assert_close(
        got, R.spmv_ell_plain(val, col, vec, **kw),
        **(TOL if dtype == torch.float32 else BF16_TOL))


def _raw_ell(cuda, dtype, rows, width, cols, seed, pad=0.3):
    """ELL arrays as a user hands them over: each row's last slots (about
    ``pad`` of them) are padding (value 0, column 0), the rest random."""
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((rows, width)).astype(np.float32)
    col = rng.integers(0, cols, (rows, width)).astype(np.int32)
    used = rng.integers(int(width * (1 - 2 * pad)), width + 1, rows)
    slot = np.arange(width)[None, :]
    val[slot >= used[:, None]] = 0
    col[slot >= used[:, None]] = 0
    vec = rng.standard_normal(cols).astype(np.float32)
    return (torch.from_numpy(val).to(cuda, dtype),
            torch.from_numpy(col).to(cuda),
            torch.from_numpy(vec).to(cuda, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [
    (900, 37),      # a width that is no multiple of the 16-byte step
    (5, 384),       # fewer rows than a slab: one CTA
    (5, 37),
    (3000, 40),     # f32: 16-byte steps; bf16: 40 % 8 == 0 as well
    (2000, 36),     # f32: 16-byte steps; bf16: scalar
])
def test_direct_body_edges_match_plain(cuda, dtype, rows, width):
    """K1's direct body on widths off its 16-byte step (the scalar loads)
    and on fewer rows than a slab, with the row permutation and the fused
    epilogue, against its plain version."""
    val, col, vec = _raw_ell(cuda, dtype, rows, width, 5000, rows + width)
    assert K.ell_vector_path(val, col) == (
        width % (16 // val.element_size()) == 0)
    rng = np.random.default_rng(width)
    perm = torch.from_numpy(rng.permutation(rows).astype(np.int32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)) \
        .to(cuda)
    for kw in (dict(), dict(perm=perm, out_rows=rows + 3),
               dict(bias=bias, epilogue="silu")):
        got = K.spmv_ell_cuda(val, col, vec, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, R.spmv_ell_plain(val, col, vec, **kw),
            **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_body_takes_the_scalar_path_off_alignment(cuda, dtype):
    """val and col that do not start 16-byte aligned take the scalar loads.
    A lane then sums other slots than on the 16-byte path, so the result
    is held against the plain version, not against the aligned copy's
    bits."""
    val, col, vec = _raw_ell(cuda, dtype, 700, 64, 3000, 11)
    vbuf = torch.zeros(val.numel() + 1, dtype=dtype, device=cuda)
    cbuf = torch.zeros(col.numel() + 1, dtype=torch.int32, device=cuda)
    vbuf[1:] = val.reshape(-1)
    cbuf[1:] = col.reshape(-1)
    sval, scol = vbuf[1:].view(700, 64), cbuf[1:].view(700, 64)
    assert K.ell_vector_path(val, col)
    assert not K.ell_vector_path(sval, scol)
    got = K.spmv_ell_cuda(sval, scol, vec)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R.spmv_ell_plain(val, col, vec),
                               **(TOL if dtype == torch.float32
                                  else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [384, 37])
def test_direct_body_padding_times_inf_is_nan_as_plain(cuda, dtype, width):
    """vec[0] = inf: the padding (value 0, column 0) gathers it, so 0 * inf
    makes its row NaN, in the kernel as in the plain version; rows with a
    real entry at column 0 and no padding are +-inf.  The body reads and
    gathers every slot."""
    val, col, vec = _raw_ell(cuda, dtype, 2000, width, 1000, width)
    # every third row full, at columns past 5: finite; every seventh with
    # a real entry at column 0 as well
    gen = torch.Generator(device=cuda).manual_seed(width)
    val[::3] = torch.randn(val[::3].shape, generator=gen, device=cuda) \
        .to(dtype) + 8
    col[::3] = torch.randint(6, 1000, col[::3].shape, generator=gen,
                             device=cuda, dtype=torch.int32)
    col[::7, 0] = 0
    vec[0] = float("inf")
    vec[5] = float("nan")
    got = K.spmv_ell_cuda(val, col, vec)
    want = R.spmv_ell_plain(val, col, vec)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any()) and bool(torch.isfinite(want).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, equal_nan=True,
                               **(TOL if dtype == torch.float32
                                  else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [6000, 120000])
@pytest.mark.parametrize("width", [128, 132])
def test_direct_body_staged_prefix_does_not_move_bits(cuda, dtype, cols,
                                                      width):
    """How much of the vector the direct body stages in each CTA's shared
    memory follows from the matrix (the launcher's rule: min(cols, 192 KB,
    a quarter of a CTA's slots)); it changes where a gather reads, not what
    it reads.  The first k rows, called alone, stage less than the whole
    matrix does (at width 128 on 132 SMs: 96 elements at 3 rows, 914 at
    200, 4,848 at 20,000; the whole 240,000 rows 58,181, capped at 49,152
    in f32, or at 6,000 columns the whole vector), and each gives the
    whole matrix's bits for its rows, on the 16-byte path (width 128) and
    on the scalar one (132 in bf16); the whole matrix is held against the
    plain version."""
    rows = 240_000
    val, col, vec = _raw_ell(cuda, dtype, rows, width, cols, 3)
    want = K.spmv_ell_cuda(val, col, vec)
    torch.cuda.synchronize()
    torch.testing.assert_close(want, R.spmv_ell_plain(val, col, vec),
                               **(TOL if dtype == torch.float32
                                  else BF16_TOL))
    for k in (3, 200, 20_000):
        got = K.spmv_ell_cuda(val[:k], col[:k], vec)
        torch.cuda.synchronize()
        assert torch.equal(got, want[:k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue,with_bias,with_perm", EPILOGUES)
def test_windowed_kernel_matches_plain(cuda, dtype, epilogue, with_bias,
                                       with_perm):
    val, col, perm, vec, bias = _ell(cuda, dtype)
    w = tf.ell_windows(val, col, 3000, window=512)
    assert w.n_windows == 6 and w.col.dtype == torch.uint16
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    before = K.LAUNCHES["spmv_ell_windowed"]
    got = K.spmv_ell_windowed_cuda(w, vec, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_windowed"] == before + 1
    torch.testing.assert_close(
        got, R.spmv_ell_windowed_plain(w, vec, **kw),
        **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", [None, "none", "relu", "silu"])
def test_windowed_kernel_edges(cuda, dtype, epilogue):
    """Rows whose entries straddle two windows (columns 1000-1060 against
    a window of 1024), an empty slab (rows 32-63, unsorted), a ragged last
    slab (100 rows), a row permutation and a bias by output row."""
    rng = np.random.default_rng(8)
    d = np.zeros((100, 2048), np.float32)
    d[:, 1000:1061] = rng.standard_normal((100, 61))
    d[rng.random((100, 2048)) > 0.5] = 0
    d[32:64] = 0
    ell = tf.ell_from_csr(tf.csr_from_dense(d), sort_rows=False, lane=8)
    val, col = ell.val.to(cuda, dtype), ell.col.to(cuda)
    w = tf.ell_windows(val, col, 2048, window=1024)
    assert torch.diff(w.seg_ptr).tolist() == [2, 0, 2, 2]
    vec = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(100).astype(np.int32))
    bias = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    kw = dict(bias=bias.to(cuda), perm=perm.to(cuda), epilogue=epilogue)
    vec = vec.to(cuda, dtype)
    got = K.spmv_ell_windowed_cuda(w, vec, **kw)
    torch.cuda.synchronize()
    want = R.spmv_ell_windowed_plain(w, vec, **kw)
    torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                             else BF16_TOL))
    empty = perm[32:64].long()
    torch.testing.assert_close(
        got[empty].cpu(), apply_epilogue_inregister(bias[empty], None, epilogue))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue,with_bias,with_perm", EPILOGUES)
@pytest.mark.parametrize("window", [512, 3000])
def test_staged_kernel_matches_plain(cuda, dtype, epilogue, with_bias,
                                     with_perm, window):
    """K1's staged body over 6 windows of the vector and over one."""
    val, col, perm, vec, bias = _ell(cuda, dtype)
    w = tf.ell_windows(val, col, 3000, window=window)
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    before = dict(K.LAUNCHES)
    got = K.spmv_ell_staged_cuda(w, vec, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_staged"] == before["spmv_ell_staged"] + 1
    assert K.LAUNCHES["spmv_ell_windowed"] == before["spmv_ell_windowed"]
    torch.testing.assert_close(
        got, R.spmv_ell_windowed_plain(w, vec, **kw),
        **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", [None, "relu", "silu"])
def test_staged_kernel_edges(cuda, dtype, epilogue):
    """Rows straddling two windows, an empty slab, a ragged last slab, a
    row permutation and a bias by output row, and a window (1,000) whose
    start is not 16-byte aligned in bf16, so part of the stage is copied
    element by element."""
    rng = np.random.default_rng(8)
    d = np.zeros((100, 2048), np.float32)
    d[:, 990:1061] = rng.standard_normal((100, 71))
    d[rng.random((100, 2048)) > 0.5] = 0
    d[32:64] = 0
    ell = tf.ell_from_csr(tf.csr_from_dense(d), sort_rows=False, lane=8)
    val, col = ell.val.to(cuda, dtype), ell.col.to(cuda)
    w = tf.ell_windows(val, col, 2048, window=1000)
    assert torch.diff(w.seg_ptr).tolist()[1] == 0
    vec = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(100).astype(np.int32))
    bias = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    kw = dict(bias=bias.to(cuda), perm=perm.to(cuda), epilogue=epilogue)
    vec = vec.to(cuda, dtype)
    got = K.spmv_ell_staged_cuda(w, vec, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, R.spmv_ell_windowed_plain(w, vec, **kw),
        **(TOL if dtype == torch.float32 else BF16_TOL))
    empty = perm[32:64].long()
    torch.testing.assert_close(
        got[empty].cpu(), apply_epilogue_inregister(bias[empty], None, epilogue))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_kernel_at_the_resident_limit(cuda, dtype):
    """A vector of RESIDENT_VEC_LIMIT elements: 19 windows of 55,192 f32 or
    16 of 65,536 bf16, and enough slabs (20,000 rows) that each CTA holds
    several.  In f32 through the marshaled path (pack_ell128, then
    spmv_ell_packed), in bf16 on a layout built the same way."""
    rng = np.random.default_rng(11)
    rows, cols = 20_000, ell_ops.RESIDENT_VEC_LIMIT
    counts = rng.integers(0, 60, rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    c = np.concatenate([np.sort(rng.choice(cols, k, replace=False))
                        for k in counts]).astype(np.int32)
    csr = tf.CSR(torch.from_numpy(rng.standard_normal(c.shape[0])
                                  .astype(np.float32)).to(cuda),
                 torch.from_numpy(c).to(cuda),
                 torch.from_numpy(row_ptr).to(cuda), (rows, cols))
    size = torch.tensor([], dtype=dtype).element_size()
    if dtype == torch.float32:
        layout = ell_ops.pack_ell128(csr)
    else:
        ell = tf.ell_from_csr(csr, lane=128)
        layout = tf.ell_windows(ell.val.to(dtype), ell.col, cols,
                                window=ell_ops.staged_window(cols, size),
                                perm=ell.perm)
    assert layout.n_windows == (19 if dtype == torch.float32 else 16)
    vec = torch.randn(cols, device=cuda).to(dtype)
    bias = torch.randn(rows, device=cuda)
    before = dict(K.LAUNCHES)
    got = ell_ops.spmv_ell_packed(layout, vec, epilogue="relu", bias=bias)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_staged"] == before["spmv_ell_staged"] + 1
    want = R.spmv_ell_windowed_plain(layout, vec, bias=bias,
                                     perm=layout.perm, out_rows=rows,
                                     epilogue="relu")
    torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                             else BF16_TOL))


@pytest.mark.gpu
def test_wrapper_refuses_bad_operands(cuda):
    val = torch.ones(8, 16, device=cuda)
    col = torch.zeros(8, 16, dtype=torch.int32, device=cuda)
    vec = torch.ones(4, device=cuda)
    with pytest.raises(TypeError):
        K.spmv_ell_cuda(val, col.long(), vec)
    with pytest.raises(TypeError):
        K.spmv_ell_cuda(val, col, vec.double())
    with pytest.raises(ValueError):
        K.spmv_ell_cuda(val, col, vec, bias=torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        K.spmv_ell_cuda(val.t(), col.t(), vec)
    w = tf.ell_windows(val, col, 4, window=4)
    with pytest.raises(TypeError):
        K.spmv_ell_windowed_cuda(dataclasses.replace(w, col=w.col.int()), vec)
    with pytest.raises(ValueError):
        K.spmv_ell_windowed_cuda(w, vec[:3])
    with pytest.raises(ValueError):     # segments that end past the slots
        K.spmv_ell_windowed_cuda(dataclasses.replace(
            w, val=w.val[:-32], col=w.col[:-32]), vec)
    with pytest.raises(ValueError):
        K.spmv_ell_windowed_cuda(w, vec, bias=torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        K.spmv_ell_staged_cuda(w, vec[:3])
    wide = tf.ell_windows(val, col, 4, window=1 << 16)
    with pytest.raises(ValueError):     # a window past shared memory
        K.spmv_ell_staged_cuda(wide, vec)


@pytest.mark.gpu
def test_compiled_csr_spmv_runs_the_kernel(cuda):
    """The host-mode path on the card: detect, repack once, launch K1's
    staged body."""
    csr = tf.from_numpy(tf.to_numpy(trandom.random_csr(300, 200, 0.05,
                                                       seed=2)),
                        kind="CSR", device=cuda)
    v = torch.randn(200, device=cuda)

    def naive(val, col, row_ptr, v):
        rows = row_ptr.shape[0] - 1
        row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                      torch.diff(row_ptr),
                                      output_size=val.shape[0])
        return torch.zeros(rows, device=val.device).index_add_(
            0, row, val * v[col])

    fast = lilac.compile(naive, mode="host", policy="cuda.ell")
    before = dict(K.LAUNCHES)
    for _ in range(3):
        out = fast(csr.val, csr.col_ind, csr.row_ptr, v)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_staged"] == before["spmv_ell_staged"] + 3
    assert K.LAUNCHES["spmv_ell"] == before["spmv_ell"]
    assert fast.cache.stats.misses == 1
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    torch.testing.assert_close(out, naive(csr.val, csr.col_ind, csr.row_ptr,
                                          v), **TOL)


def _packed(cuda, dtype, bm=128, rows=700, cols=600, density=0.03, seed=4):
    """The packed tiles of a random matrix with its block rows 1 (and 3)
    empty, built on the card."""
    d = trandom.random_dense_sparse(rows, cols, density, seed=seed)
    d[bm:2 * bm] = 0
    if rows > 4 * bm:
        d[3 * bm:4 * bm] = 0
    csr = tf.csr_from_dense(d, device=cuda)
    csr = tf.CSR(csr.val.to(dtype), csr.col_ind, csr.row_ptr, csr.shape)
    return tconvert.csr_to_packed_bcsr(csr, (bm, 128))


K3_CASES = [(None, None), ("relu", "row"), ("silu", "col"), ("none", "row"),
            ("none", "col"), ("relu", None), ("silu", "row"), ("relu", "col")]


def _k3_body(n):
    return "bsr_spmm_narrow" if n <= K3.NARROW_N else "bsr_spmm_wide"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue,bias_kind", K3_CASES)
@pytest.mark.parametrize("n", [1, 3, 8, 100, 128, 200])
def test_bsr_spmm_kernel_matches_plain(cuda, dtype, epilogue, bias_kind, n):
    """Every epilogue and bias kind, empty block rows, N = 1 (the SpMV
    harness's width), 3 and 8 on the narrow body, 100 (a copy padded to a
    16-byte row in bf16), 128 and a ragged 200 on the wide one, a dense
    operand shorter than the padded columns, and rows cut short of the
    last block row."""
    b = _packed(cuda, dtype)
    rng = np.random.default_rng(2)
    dense = torch.from_numpy(rng.standard_normal((590, n)).astype(
        np.float32)).to(cuda, dtype)
    rows = 690
    bias = None if bias_kind is None else torch.from_numpy(
        rng.standard_normal(rows if bias_kind == "row" else n)
        .astype(np.float32)).to(cuda)
    kw = dict(out_rows=rows, bias=bias, bias_kind=bias_kind,
              epilogue=epilogue)
    before = dict(K3.LAUNCHES)
    got = K3.bsr_spmm_cuda(b, dense, **kw)
    torch.cuda.synchronize()
    body = _k3_body(n)
    assert K3.LAUNCHES[body] == before[body] + 1
    assert sum(K3.LAUNCHES.values()) == sum(before.values()) + 1
    want = R3.bsr_spmm_plain(b, dense, **kw)
    assert got.shape == (rows, n)
    torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                             else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [8, 64])
@pytest.mark.parametrize("n", [1, 64])
def test_bsr_spmm_kernel_short_tiles(cuda, bm, n):
    b = _packed(cuda, torch.float32, bm=bm, rows=512, cols=384, density=0.1)
    dense = torch.randn(384, n, device=cuda)
    got = K3.bsr_spmm_cuda(b, dense, epilogue="relu")
    want = R3.bsr_spmm_plain(b, dense, epilogue="relu")
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128])
def test_bsr_spmm_kernel_block_rows_without_tiles(cuda, n):
    """A layout whose block row 1 has no tile at all (not even the explicit
    empty one the repack keeps) stores epilogue(0 + bias) there."""
    b = _packed(cuda, torch.float32, rows=256, cols=256, density=0.2)
    ptr = b.tile_ptr[:2].clone()
    bare = dataclasses.replace(
        b, val=b.val[:int(ptr[1])], local=b.local[:int(ptr[1])],
        tile_ptr=ptr, row_start=b.row_start[:1], col_mask=b.col_mask[:1],
        block_col=b.block_col[:1],
        block_rowptr=torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda))
    dense = torch.randn(256, n, device=cuda)
    bias = torch.randn(256, device=cuda)
    got = K3.bsr_spmm_cuda(bare, dense, bias=bias, bias_kind="row",
                           epilogue="silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R3.bsr_spmm_plain(
        bare, dense, bias=bias, bias_kind="row", epilogue="silu"), **TOL)
    torch.testing.assert_close(
        got[128:], apply_epilogue_inregister(bias[128:, None].expand(-1, n),
                                             None, "silu"))


@pytest.mark.gpu
def test_bsr_spmm_kernel_on_the_stencil(cuda):
    """HPCG's operator on a 24^3 grid in 128x128 tiles at the GNN's
    N = 128 with its relu and column bias, and at the CG's N = 1."""
    csr = trandom.stencil27_csr(24, 24, 24, device=cuda)
    b = tconvert.csr_to_packed_bcsr(csr, (128, 128))
    for n, kw in ((128, dict(bias=torch.randn(128, device=cuda),
                             bias_kind="col", epilogue="relu")), (1, {})):
        dense = torch.randn(csr.cols, n, device=cuda)
        got = K3.bsr_spmm_cuda(b, dense, out_rows=csr.rows, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, R3.bsr_spmm_plain(b, dense, out_rows=csr.rows, **kw), **TOL)


GMM_BF16_TOL = dict(atol=1e-3, rtol=1e-3)   # bf16 products are exact in f32


def _gmm_operands(cuda, dtype, Tp, D, F, E, tm, seed):
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal((Tp, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32))
    te = torch.from_numpy(rng.integers(0, E, Tp // tm).astype(np.int32))
    return xs.to(cuda, dtype), w.to(cuda, dtype), te.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tp,D,F,E,tm", [
    (256, 128, 256, 4, 128),
    (96, 96, 192, 4, 16),       # D not a multiple of 64, F of 128
    (64, 64, 128, 8, 8),
    (512, 64, 128, 2, 256),     # a tile taller than a CTA
    (128, 200, 136, 3, 32),     # D and F multiples of 8 only
])
def test_gmm_kernel_matches_plain(cuda, dtype, Tp, D, F, E, tm):
    xs, w, te = _gmm_operands(cuda, dtype, Tp, D, F, E, tm, Tp + D)
    body = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
    before = dict(K4.LAUNCHES)
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == {**before, body: before[body] + 1}
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm),
                               **(TOL if dtype == torch.float32
                                  else GMM_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("D,F", [(2048, 1024), (1024, 2048)])
def test_gmm_tensor_core_kernel_at_olmoe_widths(cuda, D, F):
    """OLMoE's gate/up (D 2048 -> F 1024) and down (1024 -> 2048) widths
    with 8 experts and tm = 128, in bf16."""
    xs, w, te = _gmm_operands(cuda, torch.bfloat16, 1024, D, F, 8, 128, D)
    got = K4.gmm_cuda(xs, w, te, tm=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 128),
                               **GMM_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D,F", [(2048, 1024), (1024, 2048)])
def test_gmm_f32_body_at_olmoe_widths(cuda, D, F):
    """OLMoE's gate/up and down widths with 8 experts and tm = 128 in f32,
    on the f32 body's 16-byte path.  w is drawn at the model's scale
    (std 1/sqrt(D), as moe_params draws it), so that a sum of D products
    is O(1) and the f32 rounding of its D steps (~2^-24 each) stays far
    inside TOL."""
    xs, w, te = _gmm_operands(cuda, torch.float32, 1024, D, F, 8, 128, D)
    w = w / D ** 0.5
    assert K4.f32_vector_path(xs, w)
    before = dict(K4.LAUNCHES)
    got = K4.gmm_cuda(xs, w, te, tm=128)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == {**before, "gmm_f32": before["gmm_f32"] + 1}
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 128), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("Tp,D,F,tm", [
    (96, 37, 50, 32),       # D and F no multiples of 4: the scalar path
    (256, 37, 130, 128),
    (128, 8, 3, 64),
    (384, 61, 256, 384),    # a tile three CTAs tall
])
def test_gmm_f32_body_scalar_path_matches_plain(cuda, Tp, D, F, tm):
    xs, w, te = _gmm_operands(cuda, torch.float32, Tp, D, F, 3, tm, D + F)
    assert not K4.f32_vector_path(xs, w)
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm), **TOL)


@pytest.mark.gpu
def test_gmm_f32_body_takes_the_scalar_path_off_alignment(cuda):
    """xs views whose data is not 16-byte aligned take the scalar path:
    ``big[1:]`` of an odd D, and a flat buffer shifted by one element at a
    D that is a multiple of 4.  Both paths sum each output over k in the
    same order, so the shifted copy gives the aligned copy's bits."""
    rng = np.random.default_rng(8)
    te = torch.tensor([1, 0, 2, 1], dtype=torch.int32, device=cuda)
    big = torch.from_numpy(rng.standard_normal((257, 37)).astype(np.float32)
                           ).to(cuda)
    w = torch.randn(3, 37, 64, device=cuda)
    xs = big[1:]
    assert xs.is_contiguous() and not K4.f32_vector_path(xs, w)
    got = K4.gmm_cuda(xs, w, te, tm=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 64), **TOL)
    xa, wa, _ = _gmm_operands(cuda, torch.float32, 256, 64, 128, 3, 64, 9)
    flat = torch.zeros(xa.numel() + 1, device=cuda)
    flat[1:] = xa.reshape(-1)
    shifted = flat[1:].view(256, 64)
    assert K4.f32_vector_path(xa, wa)
    assert not K4.f32_vector_path(shifted, wa)
    aligned = K4.gmm_cuda(xa, wa, te, tm=64)
    got = K4.gmm_cuda(shifted, wa, te, tm=64)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    torch.testing.assert_close(got, R4.gmm_ref(xa, wa, te, 64), **TOL)


@pytest.mark.gpu
def test_gmm_f32_body_gives_zeros_for_zero_tail_rows(cuda):
    """The tail tiles past the last group hold zero rows (moe_ffn's xs):
    they come out as zeros."""
    xs, w, te = _gmm_operands(cuda, torch.float32, 512, 128, 256, 4, 128, 2)
    xs[384:] = 0
    got = K4.gmm_cuda(xs, w, te, tm=128)
    torch.cuda.synchronize()
    assert bool((got[384:] == 0).all())
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 128), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_takes_out_of_range_expert_ids_as_plain(cuda, dtype):
    """Expert ids past E or below 0 read no weight past w: the kernel maps
    them as its plain version does (negative from the end, then clamped)."""
    rng = np.random.default_rng(5)
    E = 3
    xs = torch.from_numpy(rng.standard_normal((80, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, 32, 64)).astype(np.float32))
    xs, w = xs.to(cuda, dtype), w.to(cuda, dtype)
    te = torch.tensor([E, -1, E + 1000, -E - 1000, 1], dtype=torch.int32,
                      device=cuda)
    got = K4.gmm_cuda(xs, w, te, tm=16)
    torch.cuda.synchronize()
    in_range = torch.tensor([E - 1, E - 1, E - 1, 0, 1], dtype=torch.int32,
                            device=cuda)
    tol = TOL if dtype == torch.float32 else GMM_BF16_TOL
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, in_range, 16), **tol)
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 16), **tol)


@pytest.mark.gpu
def test_k3_k4_wrappers_refuse_bad_operands(cuda):
    b = _packed(cuda, torch.float32)
    dense = torch.randn(600, 8, device=cuda)
    with pytest.raises(TypeError):
        K3.bsr_spmm_cuda(dataclasses.replace(b, val=b.val.double()), dense)
    with pytest.raises(TypeError):
        K3.bsr_spmm_cuda(b, dense.half())
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b, dense, bias=torch.ones(3, device=cuda),
                         bias_kind="col")
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b, dense, bias=torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b, dense.t())
    with pytest.raises(ValueError):     # ids that leave their row
        dataclasses.replace(b, row_start=torch.zeros_like(b.row_start))
    xs = torch.randn(256, 64, device=cuda)
    w = torch.randn(2, 64, 128, device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs, w, te, tm=96)
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs, w, torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        K4.gmm_cuda(xs, w.bfloat16(), te, tm=128)
    # TMA strides are 16-byte multiples: a bf16 D or F that is not a
    # multiple of 8, or a misaligned operand, raises
    bw = torch.randn(2, 64, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs[:, :60].bfloat16().contiguous(),
                    bw[:, :60].contiguous(), te)
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs.bfloat16(), bw[:, :, :100].contiguous(), te)
    shifted = torch.randn(256 * 64 + 1, device=cuda).bfloat16()[1:]
    with pytest.raises(ValueError):
        K4.gmm_cuda(shifted.view(256, 64), bw, te)


@pytest.mark.gpu
def test_compiled_spmm_and_moe_run_their_kernels(cuda):
    """The default policy on the card: spmm_csr on cuda.bcsr (one repack,
    one K3 launch a call), moe_ffn on cuda.gmm (three K4 launches a call:
    the block vmaps its two sequences into one call)."""
    csr = tf.from_numpy(tf.to_numpy(trandom.random_csr(300, 200, 0.05,
                                                       seed=2)),
                        kind="CSR", device=cuda)
    h = torch.randn(200, 16, device=cuda)    # the wide body: N > 8
    bias = torch.randn(16, device=cuda)

    def layer(val, col, row_ptr, h, bias):
        rows = row_ptr.shape[0] - 1
        r = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                    torch.diff(row_ptr),
                                    output_size=val.shape[0])
        out = torch.zeros(rows, h.shape[1], device=val.device)
        return torch.relu(out.index_add_(0, r, val[:, None] * h[col]) + bias)

    fast = lilac.compile(layer, mode="host")
    before = K3.LAUNCHES["bsr_spmm_wide"]
    for _ in range(3):
        out = fast(csr.val, csr.col_ind, csr.row_ptr, h, bias)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["bsr_spmm_wide"] == before + 3
    assert fast.cache.stats.misses == 1
    assert [n for _, n in fast.last_selections] == ["cuda.bcsr"]
    torch.testing.assert_close(out, layer(csr.val, csr.col_ind, csr.row_ptr,
                                          h, bias), **TOL)

    gen = torch.Generator(device=cuda).manual_seed(0)
    p = tlayers.moe_params(tlayers.moe_spec(64, 32, 8, torch.float32), gen)
    x = torch.randn(2, 40, 64, generator=gen, device=cuda)
    before = K4.LAUNCHES["gmm_f32"]
    got, _ = tlayers.moe_block(p, x, topk=2, impl="lilac")
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm_f32"] == before + 3
    fast = tlayers._lilac_moe_2d("cuda")
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    want, _ = tlayers.moe_block(p, x, topk=2, impl="naive")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_compiled_bf16_moe_runs_the_tensor_core_kernel(cuda):
    """The MoE path in bf16, as OLMoE runs it: moe_ffn on cuda.gmm, three
    launches of K4's tensor-core body for both sequences (vmapped into one
    call), within bf16 rounding of the f32 oracle (relative L2 error, as
    chip_smoke.py states it)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = tlayers.moe_params(tlayers.moe_spec(64, 32, 8, torch.bfloat16), gen)
    x = torch.randn(2, 40, 64, generator=gen, device=cuda).bfloat16()
    before = K4.LAUNCHES["gmm"]
    got, _ = tlayers.moe_block(p, x, topk=2, impl="lilac")
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] == before + 3
    fast = tlayers._lilac_moe_2d("cuda")
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    gate, idx, _ = tlayers.moe_router(p, x, 2)
    for b in range(2):
        want = R4.moe_ffn_ref(x[b], gate[b], idx[b], p["wg"], p["wu"],
                              p["wd"])
        err = torch.linalg.vector_norm(got[b].float() - want) \
            / torch.linalg.vector_norm(want)
        assert got.dtype == torch.bfloat16 and float(err) <= 2e-2


# ---------------------------------------------------------------------------
# tune clauses, custom ops, trace mode and the autotuner on the card
# ---------------------------------------------------------------------------

ELL_SLABS = [s["rows_per_slab"] for s in
             lilac.REGISTRY.get("spmv_ell", "cuda.ell").schedules]
GMM_TILES = [s["tm"] for s in
             lilac.REGISTRY.get("moe_ffn", "cuda.gmm").schedules]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_slab", ELL_SLABS)
def test_every_declared_slab_matches_plain_bit_for_bit(cuda, dtype,
                                                       rows_per_slab):
    """K1's direct body at each declared rows_per_slab: against its plain
    version, and bit for bit against the default slab (a row is summed by
    one warp whatever the CTA covers)."""
    val, col, perm, vec, bias = _ell(cuda, dtype)
    kw = dict(bias=bias, perm=perm, out_rows=val.shape[0], epilogue="relu")
    got = K.spmv_ell_cuda(val, col, vec, rows_per_slab=rows_per_slab, **kw)
    base = K.spmv_ell_cuda(val, col, vec, rows_per_slab=ELL_SLABS[0], **kw)
    torch.cuda.synchronize()
    want = R.spmv_ell_plain(val, col, vec, **kw)
    torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                             else BF16_TOL))
    assert torch.equal(got, base)


@pytest.mark.gpu
def test_pagerank_on_unnormalized_links_differs_by_rounding_only(cuda):
    """PageRank over the example's graph with its raw link values (not
    split among out-links) through cuda.ell on the card: the iterate grows
    past 1e24 in 40 steps, and the compiled SpMV still agrees with the
    naive one to f32 rounding relative to it, so a large absolute
    difference there is the iterate's size, not a wrong kernel."""
    from repro_torch.examples import pagerank
    from repro_torch.examples.common import naive_spmv

    g, _ = pagerank.links(4096, cuda)
    spmv = lilac.compile(naive_spmv, mode="host", policy="cuda.ell",
                         device=cuda)
    before = K.LAUNCHES["spmv_ell_staged"]
    x = pagerank.pagerank(spmv, g, g.val, 40)
    want = pagerank.pagerank(naive_spmv, g, g.val, 40)
    scale = float(want.abs().max())
    assert scale > 1e24
    assert float((x - want).abs().max()) <= 1e-5 * scale
    assert K.LAUNCHES["spmv_ell_staged"] == before + 40


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm", GMM_TILES)
def test_every_declared_row_tile_matches_plain_bit_for_bit(cuda, dtype, tm):
    """K4 at each declared tm, alone and through moe_ffn: against the plain
    versions, and moe_ffn bit for bit against the default tile (tm moves
    the padding, not a row's sum)."""
    xs, w, te = _gmm_operands(cuda, dtype, 1024, 128, 256, 4, tm, tm)
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm),
                               **(TOL if dtype == torch.float32
                                  else GMM_BF16_TOL))
    gen = torch.Generator(device=cuda).manual_seed(1)
    # top-8: a token sums 8 pairs, whose order an atomic combine would vary
    p = tlayers.moe_params(tlayers.moe_spec(128, 64, 16, dtype), gen)
    x = torch.randn(200, 128, generator=gen, device=cuda).to(dtype)
    gate, idx, _ = tlayers.moe_router(p, x[None], 8)
    args = (x, gate[0], idx[0], p["wg"], p["wu"], p["wd"])
    out = gmm_ops.moe_ffn(*args, tm=tm)
    base = gmm_ops.moe_ffn(*args, tm=GMM_TILES[0])
    torch.cuda.synchronize()
    assert torch.equal(out, base)
    # the plain version: the same function on the CPU copies (gmm_ref)
    plain = gmm_ops.moe_ffn(*(a.cpu() for a in args), tm=tm)
    torch.testing.assert_close(out.cpu().float(), plain.float(),
                               **(dict(atol=1e-3, rtol=1e-3)
                                  if dtype == torch.float32 else BF16_TOL))


def _replayed(fn):
    """``fn()`` eagerly, and captured in a CUDA graph and replayed."""
    eager = fn()
    fn()                                # warm on the side stream's pool
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return eager, out


@pytest.mark.gpu
def test_custom_ops_replay_in_a_cuda_graph(cuda):
    val, col, perm, vec, bias = _ell(cuda, torch.float32)
    for args in ((val, col, vec, bias, None, None, "relu", 32),
                 (val, col, vec, None, perm, val.shape[0], None, 64)):
        eager, replay = _replayed(lambda: ell_ops.spmv_ell_op(*args))
        assert torch.equal(eager, replay)
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = tlayers.moe_params(tlayers.moe_spec(128, 64, 16, torch.bfloat16),
                           gen)
    x = torch.randn(200, 128, generator=gen, device=cuda).bfloat16()
    gate, idx, _ = tlayers.moe_router(p, x[None], 8)
    for tm in GMM_TILES:
        eager, replay = _replayed(lambda: gmm_ops.moe_ffn_op(
            x, gate[0], idx[0], p["wg"], p["wu"], p["wd"], tm))
        assert torch.equal(eager, replay)


@pytest.mark.gpu
def test_trace_mode_graphs_equal_host_mode_and_replay(cuda):
    """The ELL layer and the MoE FFN compiled in trace mode on the card:
    the graph holds the custom op, equals host mode bit for bit, and its
    CUDA-graph replay equals the eager call."""
    val, col, _, vec, bias = _ell(cuda, torch.float32)

    def layer(val, col, vec, bias):
        return torch.relu((val * vec[col]).sum(dim=1) + bias)

    gen = torch.Generator(device=cuda).manual_seed(3)
    p = tlayers.moe_params(tlayers.moe_spec(128, 64, 16, torch.bfloat16),
                           gen)
    x = torch.randn(200, 128, generator=gen, device=cuda).bfloat16()
    gate, idx, _ = tlayers.moe_router(p, x[None], 8)
    cases = [(layer, (val, col, vec, bias), "spmv_ell", "cuda.ell"),
             (tlayers._moe_naive_2d,
              (x, gate[0], idx[0], p["wg"], p["wu"], p["wd"]), "moe_ffn",
              "cuda.gmm")]
    for fn, args, op, name in cases:
        fast = lilac.compile(fn)
        host = lilac.compile(fn, mode="host")
        got = fast(*args)
        assert [n for _, n in fast.last_selections] == [name]
        gm = fast.graph_for(*args)
        assert getattr(torch.ops.lilac_torch, op).default in [
            n.target for n in gm.graph.nodes]
        assert torch.equal(got, host(*args))
        eager, replay = _replayed(lambda: gm(*args)[0])
        assert torch.equal(eager, replay)


@pytest.mark.gpu
def test_k1_inside_a_rewritten_scan_body_matches_plain(cuda):
    """K1's direct body inside a rewritten scan body: relu(ELL SpMV +
    bias) summed over 6 vectors in a torch scan, compiled in trace mode.
    The rewritten graph holds one scan whose body holds
    lilac_torch::spmv_ell, K1 launches once each time torch's eager scan
    calls the step, and the output equals
    host mode's and is within TOL of the same loop over K1's plain
    version."""
    from torch._higher_order_ops.scan import scan

    val, col, _, _, bias = _ell(cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(4)
    vs = torch.randn(6, 3000, generator=gen, device=cuda)

    def loop(val, col, vs, bias):
        def step(acc, v):
            return acc + torch.relu((val * v[col]).sum(dim=1) + bias), ()

        out, _ = scan(step, torch.zeros_like(bias), vs)
        return out

    fast = lilac.compile(loop)
    gm = fast.graph_for(val, col, vs, bias)
    scans = [n for n in gm.graph.nodes
             if n.target is torch.ops.higher_order.scan]
    assert len(scans) == 1
    body = getattr(gm, scans[0].args[0].target)
    assert torch.ops.lilac_torch.spmv_ell.default in [
        n.target for n in body.graph.nodes]
    calls = [0]

    def count(c, x):
        calls[0] += 1
        return [c + x]

    # torch 2.11's eager scan calls the step once more than its length
    # (the first call infers the outputs' shapes), torch 2.13 does not
    torch.ops.higher_order.scan(count, [torch.zeros(())], [torch.ones(6)], ())
    K.reset_launches()
    got = fast(val, col, vs, bias)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell"] == calls[0]
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    assert torch.equal(got, lilac.compile(loop, mode="host")(val, col, vs,
                                                              bias))
    want = torch.zeros_like(bias)
    for v in vs:
        want = want + R.spmv_ell_plain(val, col, v, bias=bias,
                                       epilogue="relu")
    torch.testing.assert_close(got, want, **TOL)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["kernel_raise", "nan_output"])
def test_a_fault_at_a_later_scan_step_on_the_card_runs_the_scan_plain(
        cuda, kind, monkeypatch):
    """The same loop in host mode with K1 (``cuda.ell``) failing at step 2
    only, by an injected raise or NaN output: the match is disabled and
    the call runs again as the uncompiled scan, bit for bit; the NaN is
    seen after the loop, from the outputs' largest magnitudes kept on the
    card."""
    from torch._higher_order_ops.scan import scan

    val, col, _, _, bias = _ell(cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(4)
    vs = torch.randn(6, 3000, generator=gen, device=cuda)

    def loop(val, col, vs, bias):
        def step(acc, v):
            return acc + torch.relu((val * v[col]).sum(dim=1) + bias), ()

        out, _ = scan(step, torch.zeros_like(bias), vs)
        return out

    monkeypatch.setattr(faults, "ACTIVE", _AtAttempt(f"{kind}:cuda.ell", 2))
    fast = lilac.compile(loop, mode="host")
    got = fast(val, col, vs, bias)
    assert faults.ACTIVE.fired == [(kind, "cuda.ell", 2)]
    info = fast.resilience_info()
    assert info["disabled_matches"] == 1
    assert info["containment"]["fallbacks"] == 1
    assert fast.last_selections == []
    assert torch.equal(got, loop(val, col, vs, bias))


@pytest.mark.gpu
def test_host_autotune_on_the_card_picks_the_least_amortized(cuda):
    csr = tf.from_numpy(tf.to_numpy(trandom.random_csr(3000, 3000, 0.01,
                                                       seed=3)),
                        kind="CSR", device=cuda)
    vec = torch.randn(3000, device=cuda)

    def spmv(val, col, row_ptr, v):
        rows = row_ptr.shape[0] - 1
        r = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                    torch.diff(row_ptr),
                                    output_size=val.shape[0])
        return torch.zeros(rows, device=val.device).index_add_(
            0, r, val * v[col])

    fast = lilac.compile(spmv, mode="host", policy="autotune")
    args = (csr.val, csr.col_ind, csr.row_ptr, vec)
    out = fast(*args)
    torch.testing.assert_close(out, spmv(*args), **TOL)
    tuner = lilac.REGISTRY.autotuner
    rec = tuner.cache.get(tuner.last_decision.sig, "host")
    assert {"cuda.ell", "cuda.bcsr", "torch.segment"} <= set(rec["timings"])
    assert fast.last_selections[0][1] == rec["harness"] == min(
        rec["amortized_s"], key=rec["amortized_s"].get)
    timed = tuner.stats.timing_calls
    fast(*args)
    assert tuner.stats.timing_calls == timed


# ---------------------------------------------------------------------------
# executable plans: the rewritten program replayed from one CUDA graph
# ---------------------------------------------------------------------------

def _naive_spmv(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    r = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                torch.diff(row_ptr), output_size=val.shape[0])
    return torch.zeros(rows, device=val.device).index_add_(0, r, val * v[col])


def _plan_cg(fast, csr, b, iters):
    x = torch.zeros_like(b)
    r = b - fast(csr.val, csr.col_ind, csr.row_ptr, x)
    p, rs = r, torch.dot(r, r)
    for _ in range(iters):
        ap = fast(csr.val, csr.col_ind, csr.row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


_PLAN_CASES = {   # case -> (policy, kernel body, resident vector limit)
    "staged": ("cuda.ell", (K.LAUNCHES, "spmv_ell_staged"), None),
    "windowed": ("cuda.ell", (K.LAUNCHES, "spmv_ell_windowed"), 1000),
    "narrow": ("cuda.bcsr", (K3.LAUNCHES, "bsr_spmm_narrow"), None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_plan_replay_equals_the_interpreter_bit_for_bit(cuda, case,
                                                        monkeypatch):
    """A CG through a baked plan (a CUDA-graph replay a call after the
    first) and through the interpreter: the same kernels in the same
    order, so the same bits, and the same launches counted."""
    policy, (launches, body), limit = _PLAN_CASES[case]
    if limit is not None:
        monkeypatch.setattr(ell_ops, "RESIDENT_VEC_LIMIT", limit)
    csr = trandom.random_spd_csr(3000, 15, seed=4, device=cuda)
    b = torch.ones(3000, device=cuda)
    xs, counts = {}, {}
    for bake in (True, False):
        fast = lilac.compile(_naive_spmv, mode="host", policy=policy,
                             bake=bake)
        before = launches[body]
        xs[bake] = _plan_cg(fast, csr, b, 10)
        torch.cuda.synchronize()
        counts[bake] = launches[body] - before
        info = fast.plan_info()
        if bake:
            assert info["baked"] == 1 and not info["bake_errors"], info
            assert info["plan_hits"] == 10
            assert info["plans"][0]["cuda_graph"]
        else:
            assert info["baked"] == 0 and info["plan_hits"] == 0
        assert fast.cache.stats.misses == 1
    assert counts[True] == counts[False] == 11
    assert torch.equal(xs[True], xs[False])
    torch.testing.assert_close(xs[True], _plan_cg(_naive_spmv, csr, b, 10),
                               **TOL)


@pytest.mark.gpu
def test_plan_outputs_of_two_replays_do_not_alias(cuda):
    csr = trandom.random_spd_csr(2000, 9, seed=5, device=cuda)
    fast = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell")
    v1, v2 = torch.randn(2000, device=cuda), torch.randn(2000, device=cuda)
    fast(csr.val, csr.col_ind, csr.row_ptr, v1)
    y1 = fast(csr.val, csr.col_ind, csr.row_ptr, v1)
    keep = y1.clone()
    y2 = fast(csr.val, csr.col_ind, csr.row_ptr, v2)
    assert fast.plan_info()["plan_hits"] == 2
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, keep)
    torch.testing.assert_close(
        y2, _naive_spmv(csr.val, csr.col_ind, csr.row_ptr, v2), **TOL)


@pytest.mark.gpu
def test_plan_launch_counters_count_replays(cuda):
    """Each replay adds the launches recorded at capture; the bake's own
    warm-up and capture add none."""
    csr = trandom.random_spd_csr(2000, 9, seed=6, device=cuda)
    v = torch.randn(2000, device=cuda)
    for policy, (launches, body) in (
            ("cuda.ell", (K.LAUNCHES, "spmv_ell_staged")),
            ("cuda.bcsr", (K3.LAUNCHES, "bsr_spmm_narrow"))):
        fast = lilac.compile(_naive_spmv, mode="host", policy=policy)
        before = launches[body]
        for _ in range(7):
            fast(csr.val, csr.col_ind, csr.row_ptr, v)
        torch.cuda.synchronize()
        assert launches[body] - before == 7
        assert fast.plan_info()["plan_hits"] == 6


@pytest.mark.gpu
def test_inplace_edit_busts_the_plan_on_the_card(cuda):
    """One element of a > 64 KB val, off the fingerprint's sample grid,
    written in place between two replays: the plan misses, the data plane
    re-marshals, and the output is the naive one (with and without
    bake)."""
    csr = trandom.random_spd_csr(3000, 15, seed=7, device=cuda)
    v = torch.randn(3000, device=cuda)
    for bake in (True, False):
        val = csr.val.clone()
        fast = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell",
                             bake=bake)
        fast(val, csr.col_ind, csr.row_ptr, v)
        fast(val, csr.col_ind, csr.row_ptr, v)
        val[12345] += 100.0
        got = fast(val, csr.col_ind, csr.row_ptr, v)
        torch.testing.assert_close(
            got, _naive_spmv(val, csr.col_ind, csr.row_ptr, v), **TOL)
        assert fast.cache.stats.misses == 2
        val.mul_(2)
        got = fast(val, csr.col_ind, csr.row_ptr, v)
        torch.testing.assert_close(
            got, _naive_spmv(val, csr.col_ind, csr.row_ptr, v), **TOL)
        assert fast.plan_info()["rebakes"] == (2 if bake else 0)


@pytest.mark.gpu
def test_inference_tensor_edit_busts_the_plan_on_the_card(cuda):
    """A matrix made under torch.inference_mode carries no version: an
    in-place edit under inference_mode between two replays busts the plan
    through its checksum guard, and a re-upload with one element changed
    re-marshals through the data plane's checksum."""
    csr = trandom.random_spd_csr(3000, 15, seed=9, device=cuda)
    v = torch.randn(3000, device=cuda)
    with torch.inference_mode():
        val = csr.val.clone()
        fast = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell")
        fast(val, csr.col_ind, csr.row_ptr, v)
        fast(val, csr.col_ind, csr.row_ptr, v)
        assert fast.plan_info()["plan_hits"] == 1
        val[12345] += 100.0
        got = fast(val, csr.col_ind, csr.row_ptr, v)
        want = _naive_spmv(val, csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(got, want, **TOL)
    assert fast.cache.stats.misses == 2
    fast = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell")
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    fast(csr.val, csr.col_ind, csr.row_ptr, v)
    val2 = csr.val.clone()
    val2[23456] += 100.0
    got = fast(val2, csr.col_ind, csr.row_ptr, v)
    torch.testing.assert_close(
        got, _naive_spmv(val2, csr.col_ind, csr.row_ptr, v), **TOL)
    assert fast.cache.stats.misses == 2 and fast.cache.stats.stale == 1


@pytest.mark.gpu
def test_plan_past_the_copy_limit_runs_eagerly(cuda, monkeypatch):
    """A plan whose replay, its copies included, times slower than its
    eager program (the timing rigged here, as a GNN step's copies make it)
    runs its program eagerly on the card: no CUDA graph, the same bits,
    one launch a call."""
    from repro_torch.core import plan as P

    monkeypatch.setattr(P, "per_call_ms", lambda *fns, **kw: [1.0, 0.5])
    csr = trandom.random_spd_csr(2000, 9, seed=8, device=cuda)
    v = torch.randn(2000, device=cuda)
    fast = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell")
    interp = lilac.compile(_naive_spmv, mode="host", policy="cuda.ell",
                           bake=False)
    before = K.LAUNCHES["spmv_ell_staged"]
    outs = [fast(csr.val, csr.col_ind, csr.row_ptr, v) for _ in range(3)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_staged"] - before == 3
    (plan,) = fast.plan_info()["plans"]
    assert not plan["cuda_graph"] and plan["hits"] == 2
    want = interp(csr.val, csr.col_ind, csr.row_ptr, v)
    assert all(torch.equal(o, want) for o in outs)


# ---------------------------------------------------------------------------
# containment on the card
# ---------------------------------------------------------------------------

def _naive_csr(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    return torch.zeros(rows, device=val.device).index_add_(0, row,
                                                          val * v[col])


def _csr_on(cuda):
    csr = tf.from_numpy(tf.to_numpy(trandom.random_csr(300, 200, 0.05,
                                                       seed=2)),
                        kind="CSR", device=cuda)
    return (csr.val, csr.col_ind, csr.row_ptr,
            torch.randn(200, device=cuda))


@pytest.mark.gpu
def test_kernel_raise_on_k1_falls_back_to_the_naive_program(cuda):
    """kernel_raise:cuda.ell: K1 never runs, the call returns the naive
    program's answer through the fallback, cuda.ell is quarantined, and
    the baked plan serves the fallback from then on."""
    from repro_torch.core.resilience import (LilacContainmentWarning,
                                             shared_quarantine)

    args = _csr_on(cuda)
    fast = lilac.compile(_naive_csr, mode="host", policy="cuda.ell")
    before = K.LAUNCHES["spmv_ell_staged"]
    with faults.inject("kernel_raise:cuda.ell") as plan, \
            pytest.warns(LilacContainmentWarning, match="cuda.ell"):
        out = fast(*args)
    again = fast(*args)
    torch.cuda.synchronize()
    assert plan.fired == [("kernel_raise", "cuda.ell", 0)]
    assert K.LAUNCHES["spmv_ell_staged"] == before
    assert [n for _, n in fast.last_selections] == ["torch.segment"]
    assert shared_quarantine().is_quarantined("spmv_csr", "cuda.ell")
    assert fast.plan_info()["plan_hits"] == 1
    for got in (out, again):
        torch.testing.assert_close(got, _naive_csr(*args), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["cuda.ell", "autotune"])
def test_a_kernel_that_fails_to_launch_raises_through_the_call(
        cuda, monkeypatch, policy):
    """A real (not injected) error of a CUDA harness on the card is not
    contained: the call raises it, under a named policy and from the
    tuner's race alike, nothing is quarantined, and no plain version
    answers in the kernel's place."""
    import warnings

    from repro_torch.core.harness import REGISTRY
    from repro_torch.core.resilience import (LilacContainmentWarning,
                                             shared_quarantine)

    def broken(b, ctx):
        raise RuntimeError("launch failed: cudaError 9")

    monkeypatch.setattr(REGISTRY.get("spmv_csr", "cuda.ell"), "fn", broken)
    fast = lilac.compile(_naive_csr, mode="host", policy=policy)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LilacContainmentWarning)
        with pytest.raises(RuntimeError, match="cudaError 9"):
            fast(*_csr_on(cuda))
    assert not shared_quarantine().active()
    assert fast.resilience_info()["containment"]["contained_exceptions"] == 0


@pytest.mark.gpu
def test_nan_output_of_k3_narrow_is_contained(cuda):
    """nan_output:cuda.bcsr at N = 1: K3's narrow body runs, its output is
    poisoned, the validator's sync catches it, and the call returns the
    naive answer."""
    args = _csr_on(cuda)
    fast = lilac.compile(_naive_csr, mode="host", policy="cuda.bcsr")
    before = K3.LAUNCHES["bsr_spmm_narrow"]
    with faults.inject("nan_output:cuda.bcsr"):
        out = fast(*args)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["bsr_spmm_narrow"] == before + 1
    c = fast.resilience_info()["containment"]
    assert c["nonfinite_outputs"] == 1 and c["quarantines"] == 1
    assert [n for _, n in fast.last_selections] != ["cuda.bcsr"]
    torch.testing.assert_close(out, _naive_csr(*args), **TOL)


@pytest.mark.gpu
def test_bf16_moe_shadowed_at_rate_one_reports_no_divergence(cuda,
                                                            monkeypatch):
    """Every plan call of the bf16 MoE block on cuda.gmm shadowed by the
    naive bf16 block: the bf16 tolerance (relative L2 <= 2e-2) reports no
    divergence, so cuda.gmm stays selected."""
    monkeypatch.setenv("LILAC_TORCH_SHADOW_RATE", "1")
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = tlayers.moe_params(tlayers.moe_spec(64, 32, 8, torch.bfloat16), gen)
    x = torch.randn(2, 48, 64, generator=gen, device=cuda).bfloat16()
    fast = tlayers._lilac_moe_2d("cuda")
    before = fast.resilience_stats.as_dict()
    for _ in range(3):
        got, _ = tlayers.moe_block(p, x, topk=2, impl="lilac")
    after = fast.resilience_stats.as_dict()
    assert after["shadow_checks"] - before["shadow_checks"] >= 4
    assert after["shadow_divergences"] == before["shadow_divergences"]
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    want, _ = tlayers.moe_block(p, x, topk=2, impl="naive")
    assert float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float())) <= 2e-2


# ---------------------------------------------------------------------------
# gradients through the kernels (vjp clauses, register_autograd formulas)
# ---------------------------------------------------------------------------

def _naive_spmv(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def _naive_spmm(val, col, row_ptr, h):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros((rows, h.shape[1]), dtype=h.dtype, device=h.device)
    return out.index_add_(0, row, val[:, None] * h[col])


def _grad_problem(cuda, cols=700, width=None):
    csr = trandom.random_csr(500, cols, 0.03, seed=4, skew=1.0)
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.standard_normal(cols if width is None
                                             else (cols, width))
                         .astype(np.float32)).to(cuda)
    return csr.val.to(cuda), csr.col_ind.to(cuda), csr.row_ptr.to(cuda), v


def _grads(fn, val, col, ptr, x):
    a, b = val.clone().requires_grad_(), x.clone().requires_grad_()
    (fn(a, col, ptr, b) ** 2).sum().backward()
    return a.grad, b.grad


def _close_to_scale(got, want):
    """Gradients as chip_smoke holds them: |got - want| <= 1e-5 * max
    |want| + 1e-4 * |want|.  Each is an f32 sum in another order than the
    plain program's (atomics), through forward sums that cancel in some
    rows, so an element far below the gradient's scale carries the
    scale's rounding."""
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("policy,kernel", [("cuda.ell", "spmv_ell_staged"),
                                           ("cuda.bcsr", "bsr_spmm_narrow")])
def test_spmv_gradients_through_each_cuda_harness(cuda, policy, kernel):
    val, col, ptr, x = _grad_problem(cuda)
    fast = lilac.compile(_naive_spmv, mode="host", policy=policy)
    launches = K.LAUNCHES if kernel.startswith("spmv") else K3.LAUNCHES
    before = launches[kernel]
    got = _grads(fast, val, col, ptr, x)
    assert launches[kernel] == before + 1
    assert [n for _, n in fast.last_selections] == [policy]
    want = _grads(_naive_spmv, val, col, ptr, x)
    _close_to_scale(got, want)
    f = torch.func.grad(lambda v, xx: (fast(v, col, ptr, xx) ** 2).sum(),
                        argnums=(0, 1))(val, x)
    _close_to_scale(f, want)


@pytest.mark.gpu
def test_spmm_gradients_through_cuda_bcsr(cuda):
    val, col, ptr, h = _grad_problem(cuda, width=64)
    fast = lilac.compile(_naive_spmm, mode="host")
    before = K3.LAUNCHES["bsr_spmm_wide"]
    got = _grads(fast, val, col, ptr, h)
    assert K3.LAUNCHES["bsr_spmm_wide"] == before + 1
    assert [n for _, n in fast.last_selections] == ["cuda.bcsr"]
    _close_to_scale(got, _grads(_naive_spmm, val, col, ptr, h))


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", [None, "relu", "silu"])
def test_spmv_ell_op_formula_against_plain_autograd(cuda, epilogue):
    """The op's formula on the kernel (K1 direct) against autograd
    through its plain version on the same inputs."""
    val, col, perm, vec, bias = _ell(cuda, torch.float32)
    args = [t.clone().requires_grad_() for t in (val, vec, bias)]
    out = ell_ops.spmv_ell_op(args[0], col, args[1], args[2], None, None,
                              epilogue, 32)
    (out ** 2).sum().backward()
    ref = [t.clone().requires_grad_() for t in (val, vec, bias)]
    (R.spmv_ell_plain(ref[0], col, ref[1], bias=ref[2],
                      epilogue=epilogue) ** 2).sum().backward()
    _close_to_scale([a.grad for a in args], [b.grad for b in ref])


@pytest.mark.gpu
def test_moe_ffn_op_formula_against_plain_autograd(cuda):
    """K4 forward, ``moe_ffn_bwd`` backward, against autograd through the
    dense oracle, with balanced routing (no pair past capacity)."""
    rng = np.random.default_rng(7)
    T, D, F, E, K = 256, 64, 32, 8, 2

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    x, gate = t(rng.standard_normal((T, D))), t(rng.random((T, K)))
    idx = torch.from_numpy((np.arange(T * K).reshape(T, K) % E)
                           .astype(np.int32)).to(cuda)
    ws = [t(rng.standard_normal(s) * .1) for s in ((E, D, F), (E, D, F),
                                                   (E, F, D))]
    args = [a.clone().requires_grad_() for a in (x, gate, *ws)]
    before = K4.LAUNCHES["gmm_f32"]
    out = gmm_ops.moe_ffn_op(args[0], args[1], idx, *args[2:], 128)
    assert K4.LAUNCHES["gmm_f32"] == before + 3
    (out ** 2).sum().backward()
    ref = [a.clone().requires_grad_() for a in (x, gate, *ws)]
    (R4.moe_ffn_ref(ref[0], ref[1], idx, *ref[2:]) ** 2).sum().backward()
    for a, b in zip(args, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_func_grad_of_compiled_call_and_compiled_grad(cuda):
    """torch.func.grad over a compiled call (the clause's Function on the
    unwrapped tensors) and a compiled torch.func.grad (both SpMVs
    detected, a plan served from its third call)."""
    val, col, ptr, x = _grad_problem(cuda)

    def loss(v, c, r, xx):
        return (_naive_spmv(v, c, r, xx) ** 2).sum()

    want = torch.func.grad(loss, argnums=(0, 3))(val, col, ptr, x)
    fast = lilac.compile(_naive_spmv, policy="cuda.ell", mode="host")
    got = torch.func.grad(lambda v, xx: (fast(v, col, ptr, xx) ** 2).sum(),
                          argnums=(0, 1))(val, x)
    _close_to_scale(got, want)
    cog = lilac.compile(torch.func.grad(loss, argnums=(0, 3)), mode="host",
                        policy="cuda.ell")
    for _ in range(3):
        got = cog(val, col, ptr, x)
    assert [(m.computation, m.format) for m in cog.last_report.matches] \
        == [("spmv_csr", "CSR"), ("spmv_csr", "COO")]
    assert cog.plan_info()["plan_hits"] >= 1
    _close_to_scale(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [0, 1])
def test_gmm_on_a_ranks_experts_with_other_pairs_at_gate_zero(cuda, rank):
    """K4 as a rank of a (data, 2) mesh runs it (the lilac MoE's mesh
    path, ``layers._moe_local_dense``): OLMoE widths, 64 experts top-8 on
    256 tokens, the rank's 32 experts, every pair of the other rank's
    experts given local expert 0 and gate 0.  Its gate/up launch against
    the plain version (GMM_BF16_TOL), each row of a pair routed to the
    rank against the same pair's row of the full-E launch (1e-6), and the
    two ranks' moe_ffn summed in f32 against the full-E moe_ffn (bf16
    rounding of each partial: 2e-2 relative L2)."""
    E, D, F, K, T, tm = 64, 2048, 1024, 8, 256, 128
    E_loc = E // 2
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    gate = torch.from_numpy(rng.random((T, K)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.choice(E, K, replace=False)
                                     for _ in range(T)]).astype(np.int32))
    ws = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1]))
                           .astype(np.float32)).to(cuda, torch.bfloat16)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    x, gate, idx = x.to(cuda, torch.bfloat16), gate.to(cuda), idx.to(cuda)

    def local(r):
        lo = r * E_loc
        valid = (idx >= lo) & (idx < lo + E_loc)
        return (torch.where(valid, idx - lo, 0), torch.where(valid, gate, 0),
                [w[lo:lo + E_loc] for w in ws], valid)

    lidx, lgate, lws, valid = local(rank)
    dest, te, tp = gmm_ops._route(lidx, T, K, E_loc, tm)
    assert tp == T * K + (E_loc - 1) * tm
    xs = torch.zeros((tp, D), dtype=torch.bfloat16, device=cuda)
    xs[dest] = x.repeat_interleave(K, dim=0)
    before = dict(K4.LAUNCHES)
    got = K4.gmm_cuda(xs, lws[0], te, tm=tm)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == {**before, "gmm": before["gmm"] + 1}
    torch.testing.assert_close(got, R4.gmm_ref(xs, lws[0], te, tm),
                               **GMM_BF16_TOL)
    fdest, fte, ftp = gmm_ops._route(idx, T, K, E, tm)
    fxs = torch.zeros((ftp, D), dtype=torch.bfloat16, device=cuda)
    fxs[fdest] = x.repeat_interleave(K, dim=0)
    full = K4.gmm_cuda(fxs, ws[0], fte, tm=tm)
    mine = valid.reshape(-1)
    torch.testing.assert_close(got[dest[mine]], full[fdest[mine]],
                               atol=1e-6, rtol=1e-6)
    parts = 0
    for r in (0, 1):
        r_idx, r_gate, r_ws, _ = local(r)
        parts = parts + gmm_ops.moe_ffn(x, r_gate, r_idx, *r_ws,
                                        tm=tm).float()
    want = gmm_ops.moe_ffn(x, gate, idx, *ws, tm=tm).float()
    assert float((parts - want).norm() / want.norm()) < 2e-2


# ---------------------------------------------------------------------------
# serving: K4 at decode shapes, the compiled decode across re-buckets
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 8])
def test_moe_ffn_at_decode_shapes(cuda, T):
    """K4 (bf16) under moe_ffn at a decode step's T tokens x top-8 of 64
    experts (T·K = 8 or 64 routed rows, most experts empty, Tp the static
    8,192 rows), OLMoE widths, against the plain versions."""
    E, D, F, K = 64, 2048, 1024, 8
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    gate = torch.from_numpy(rng.random((T, K)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.choice(E, K, replace=False)
                                     for _ in range(T)]).astype(np.int32))
    ws = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1]))
                           .astype(np.float32))
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    xb, wb = x.to(cuda, torch.bfloat16), [w.to(cuda, torch.bfloat16)
                                          for w in ws]
    dest, te, tp = gmm_ops._route(idx.to(cuda), T, K, E, 128)
    assert tp == 8192
    xs = torch.zeros((tp, D), dtype=torch.bfloat16, device=cuda)
    xs[dest] = xb.repeat_interleave(K, dim=0)
    torch.testing.assert_close(K4.gmm_cuda(xs, wb[0], te),
                               R4.gmm_ref(xs, wb[0], te, 128),
                               atol=1e-3, rtol=1e-3)
    before = K4.LAUNCHES["gmm"]
    got = gmm_ops.moe_ffn(xb, gate.to(cuda), idx.to(cuda), *wb)
    assert K4.LAUNCHES["gmm"] == before + 3
    want = R4.moe_ffn_ref(xb.float(), gate.to(cuda), idx.to(cuda),
                          *[w.float() for w in wb])
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 2e-2, rel


def _serving_model(cuda):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_map

    cfg = smoke_config(get_arch("olmoe-1b-7b")).replace(
        moe_decode_impl="naive_flat", n_layers=2)
    model = build_model(cfg)
    params = tree_map(lambda a: a.float(), model.init(
        torch.Generator(device=cuda).manual_seed(0), cuda))
    return model, params


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.gpu
def test_compiled_engine_across_rebuckets_and_slot_moves(cuda):
    """The compiled decode (baked plans, CUDA graphs) inside the engine,
    each step teacher-forced against the uncompiled decode on the same
    cache and tokens, across batch and seq re-buckets and the slot moves
    of evictions: logits and the new cache within f32 rounding, K4 (f32)
    launched 3 times a layer a step."""
    from repro_torch.models.spec import leaves
    from repro_torch.serve import (BucketPolicy, Engine, Request,
                                   ServeConfig)

    model, params = _serving_model(cuda)
    eng = Engine(model, params, ServeConfig(
        buckets=BucketPolicy(batch=(1, 2, 4), seq=(16, 32))))
    compiled, steps = eng._decode, []

    def checked(p, cache, tokens, pos):
        logits, new = compiled(p, cache, tokens, pos)
        want, want_cache = model.decode(p, cache, tokens, pos)
        steps.append((tuple(tokens.shape), cache["p0"]["b0"]["k"].shape[1],
                      _rel(logits, want),
                      max(_rel(a, b) for (_, a), (_, b) in
                          zip(leaves(new), leaves(want_cache)))))
        return logits, new

    eng._decode = checked
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, 256, size=n).astype(np.int32),
                    max_new_tokens=m)
            for n, m in ((3, 2), (5, 9), (2, 4), (12, 14), (4, 3))]
    before = K4.LAUNCHES["gmm_f32"]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    assert all(r.failed is None and len(r.tokens) == r.max_new_tokens
               for r in reqs)
    shapes = {(s[0][0], s[1]) for s in steps}
    assert len(shapes) >= 3, shapes          # re-bucketed on both axes
    assert eng.metrics.snapshot()["buckets"]["misses"] == 0
    assert max(s[2] for s in steps) <= 1e-4 and \
        max(s[3] for s in steps) <= 1e-4, steps
    assert K4.LAUNCHES["gmm_f32"] - before == 3 * 2 * len(steps)
    assert [n for _, n in compiled.last_selections] == ["cuda.gmm"] * 2
    info = compiled.plan_info()
    assert info["baked"] == 6 and info["bake_errors"] == []


@pytest.mark.gpu
def test_prewarmed_decode_plan_captures_static_buffers_once(cuda):
    """A decode plan baked by ``prewarm`` from (shape, dtype) specs holds
    the cache, the tokens and the positions in static buffers from its
    first capture: calls with caches at new addresses capture nothing
    again and compute on their own caches."""
    from repro_torch.models.spec import tree_map

    model, params = _serving_model(cuda)
    fast = lilac.compile(model.decode, mode="host", device=cuda,
                         plan_cache="off")
    specs = tree_map(lambda a: (tuple(a.shape), a.dtype),
                     model.init_cache(2, 16, device="meta"))
    rep = fast.prewarm((params, specs, ((2, 1), torch.int32),
                        ((2,), torch.int32)))
    assert rep["baked"] == 1
    tokens = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for p in ([3, 5], [4, 6], [7, 1]):
        pos = torch.tensor(p, dtype=torch.int32, device=cuda)
        c = tree_map(lambda a: torch.randn(a.shape, generator=gen,
                                           device=cuda),
                     model.init_cache(2, 16, device=cuda))
        got, _ = fast(params, c, tokens, pos)
        want, _ = model.decode(params, c, tokens, pos)
        assert _rel(got, want) <= 1e-4
    plan = fast.plan_info()["plans"][0]
    assert plan["hits"] == 3 and plan["recaptures"] == 0
    assert plan["static_inputs"], plan


@pytest.mark.gpu
def test_decode_plan_on_a_cache_at_a_new_address(cuda):
    """A baked decode plan called with another cache tensor computes on
    that tensor (a static buffer filled each call), not on the one it was
    captured on."""
    from repro_torch.models.spec import tree_map

    model, params = _serving_model(cuda)
    fast = lilac.compile(model.decode, mode="host", device=cuda)
    tokens = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)

    def cache():
        return tree_map(lambda a: torch.randn(a.shape, generator=gen,
                                              device=cuda),
                        model.init_cache(2, 16, device=cuda))

    for c in [cache(), cache(), cache()]:
        got, _ = fast(params, c, tokens, pos)
        want, _ = model.decode(params, c, tokens, pos)
        assert _rel(got, want) <= 1e-4
    info = fast.plan_info()
    assert info["plan_hits"] >= 2 and info["baked"] == 1
    assert info["plans"][0]["recaptures"] >= 1


# ---------------------------------------------------------------------------
# granite-moe-3b-a800m's shapes, and the How language's lifecycle on K1
# ---------------------------------------------------------------------------

GRANITE_D, GRANITE_F, GRANITE_E = 1536, 512, 40


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("product", ["gate_up", "down"])
@pytest.mark.parametrize("T", [1, 8, 1024])
def test_gmm_at_granite_moe_shapes(cuda, dtype, product, T):
    """K4 at granite-moe-3b-a800m's widths (D 1,536, F 512, 40 experts,
    top-8) over the rows ``_route`` gives T tokens (decode at T = 1 and 8,
    a prefill-size T = 1,024), against its plain version; w at the model's
    scale (std 1/sqrt(fan-in))."""
    K, tm = 8, 128
    k_in, n_out = (GRANITE_D, GRANITE_F) if product == "gate_up" \
        else (GRANITE_F, GRANITE_D)
    rng = np.random.default_rng(T + k_in)
    idx = torch.from_numpy(np.stack([rng.choice(GRANITE_E, K, replace=False)
                                     for _ in range(T)]).astype(np.int32))
    dest, te, tp = gmm_ops._route(idx.to(cuda), T, K, GRANITE_E, tm)
    x = torch.from_numpy(rng.standard_normal((T, k_in)).astype(np.float32))
    xs = torch.zeros((tp, k_in), device=cuda)
    xs[dest] = x.to(cuda).repeat_interleave(K, dim=0)
    w = torch.from_numpy((rng.standard_normal((GRANITE_E, k_in, n_out))
                          / k_in ** 0.5).astype(np.float32))
    xs, w = xs.to(dtype), w.to(cuda, dtype)
    body = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
    before = dict(K4.LAUNCHES)
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == {**before, body: before[body] + 1}
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm),
                               **(TOL if dtype == torch.float32
                                  else GMM_BF16_TOL))


@pytest.mark.gpu
def test_hook_bearing_spmv_harness_on_k1(cuda):
    """A spmv_csr harness with ``persistent layout``, BeforeFirstExecution
    and AfterLastExecution whose setup puts a ReadObject in its state
    (construct: K1's staged layout of the matched CSR; update: a re-pack
    on a value change): one setup and one construct over many calls, one
    update after an in-place edit, answers equal to the plain SpMV, K1's
    staged body a call, no plan, and one teardown on release."""
    from repro_torch.core.harness import _binding_to_csr

    csr = trandom.random_csr(3000, 2500, 0.01, seed=4)
    csr = tf.CSR(val=csr.val.to(cuda), col_ind=csr.col_ind.to(cuda),
                 row_ptr=csr.row_ptr.to(cuda), shape=csr.shape)
    events = []
    binding = {}

    def setup(state):
        events.append("setup")

        def pack(val):
            return ell_ops.pack_ell128(_binding_to_csr(binding["b"]))

        state["layout"] = lilac.ReadObject(
            construct=lambda v: events.append("construct") or pack(v),
            update=lambda v, s: events.append("update") or pack(v),
            destruct=lambda s: events.append("destruct"))

    def teardown(state):
        events.append("teardown")
        state["layout"].release()

    reg = lilac.HarnessRegistry()

    def body(b, ctx):
        binding["b"] = b
        layout = h.persistent["layout"].read(b["a"])
        return ell_ops.spmv_ell_packed(layout, b["iv"])

    (h,) = lilac.register_spec("""
HARNESS gpu.lifecycle implements spmv_csr
  formats CSR;
  host_only;
  persistent layout;
  BeforeFirstExecution gpu_setup;
  AfterLastExecution gpu_teardown;
""", {"gpu.lifecycle": body}, registry=reg,
        hooks={"gpu_setup": setup, "gpu_teardown": teardown})

    def naive(val, col, row_ptr, v):
        rows = row_ptr.shape[0] - 1
        row = torch.repeat_interleave(
            torch.arange(rows, device=val.device), torch.diff(row_ptr),
            output_size=val.shape[0])
        out = torch.zeros(rows, dtype=val.dtype, device=val.device)
        return out.index_add_(0, row, val * v[col])

    fast = lilac.compile(naive, mode="host", policy="gpu.lifecycle",
                         registry=reg, device=cuda)
    val = csr.val.clone()
    K.reset_launches()
    for seed in range(4):
        v = torch.randn(csr.shape[1], device=cuda,
                        generator=torch.Generator(device=cuda)
                        .manual_seed(seed))
        torch.testing.assert_close(fast(val, csr.col_ind, csr.row_ptr, v),
                                   naive(val, csr.col_ind, csr.row_ptr, v),
                                   **TOL)
    assert events == ["setup", "construct"]
    val.mul_(2)
    torch.testing.assert_close(fast(val, csr.col_ind, csr.row_ptr, v),
                               naive(val, csr.col_ind, csr.row_ptr, v), **TOL)
    assert events == ["setup", "construct", "update"]
    assert K.LAUNCHES["spmv_ell_staged"] == 5
    info = fast.plan_info()
    assert info["baked"] == 0 and "lifecycle hooks" in info["bake_errors"][0]
    h.release()
    assert events[-2:] == ["teardown", "destruct"]


@pytest.mark.gpu
def test_compiled_granite_moe_decode_runs_k4_in_both_layers(cuda):
    """granite-moe-3b-a800m at full width (24 heads on 8 kv heads, 40
    experts of d_ff 512, top-8) at smoke depth (2 layers), its decode step
    compiled: both MoE layers detected and run on cuda.gmm (3 K4 launches
    each), in f32 within 1e-4 of the uncompiled naive decode, and in bf16
    each step's argmax the uncompiled one's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_map

    cfg = get_arch("granite-moe-3b-a800m").replace(
        n_layers=2, moe_decode_impl="naive_flat")
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg.replace(cache_dtype=dtype))
        params = model.init(torch.Generator(device=cuda).manual_seed(0),
                            cuda)
        if dtype == torch.float32:
            params = tree_map(lambda a: a.float(), params)
        fast = lilac.compile(model.decode, mode="host", device=cuda,
                             plan_cache="off", bake=False)
        cache = model.init_cache(2, 32, device=cuda)
        ref_cache = tree_map(lambda a: a.clone(), cache)
        for t in range(3):
            tok = torch.full((2, 1), 5 + t, dtype=torch.int32, device=cuda)
            pos = torch.tensor([t, t], dtype=torch.int32, device=cuda)
            K4.reset_launches()
            got, cache = fast(params, cache, tok, pos)
            torch.cuda.synchronize()
            body = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
            assert K4.LAUNCHES[body] == 6
            assert [n for _, n in fast.last_selections] == ["cuda.gmm"] * 2
            want, ref_cache = model.decode(params, ref_cache, tok, pos)
            if dtype == torch.float32:
                assert _rel(got, want) <= 1e-4
            else:
                assert torch.equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# Jamba-v0.1's shapes: few, wide experts
# ---------------------------------------------------------------------------

JAMBA_D, JAMBA_F, JAMBA_E = 4096, 14336, 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("product", ["gate_up", "down"])
@pytest.mark.parametrize("T", [1, 8])
def test_gmm_at_jamba_decode_shapes(cuda, dtype, product, T):
    """K4 at Jamba-v0.1's widths (D 4,096, F 14,336, 16 experts, top-2)
    over the rows ``_route`` gives a decode step's T tokens (Tp 2,048:
    at T = 1 two routed rows and 14 or more tail tiles on expert 15),
    against its plain version; w at the model's scale."""
    K, tm = 2, 128
    k_in, n_out = (JAMBA_D, JAMBA_F) if product == "gate_up" \
        else (JAMBA_F, JAMBA_D)
    rng = np.random.default_rng(T + k_in)
    idx = torch.from_numpy(np.stack([rng.choice(JAMBA_E, K, replace=False)
                                     for _ in range(T)]).astype(np.int32))
    dest, te, tp = gmm_ops._route(idx.to(cuda), T, K, JAMBA_E, tm)
    assert tp == 2048
    x = torch.from_numpy(rng.standard_normal((T, k_in)).astype(np.float32))
    xs = torch.zeros((tp, k_in), device=cuda)
    xs[dest] = x.to(cuda).repeat_interleave(K, dim=0)
    w = (torch.randn((JAMBA_E, k_in, n_out), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(T))
         / k_in ** 0.5)
    xs, w = xs.to(dtype), w.to(dtype)
    body = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
    before = dict(K4.LAUNCHES)
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == {**before, body: before[body] + 1}
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm),
                               **(TOL if dtype == torch.float32
                                  else GMM_BF16_TOL))


@pytest.mark.gpu
def test_compiled_jamba_decode_runs_k4_in_its_moe_layers(cuda):
    """Jamba at one period (1 attention + 7 Mamba layers, MoE on the 4
    odd layers) at a reduced width (d_model 1,024, 16 experts of d_ff
    2,048, top-2), its decode step compiled: the 4 MoE layers on cuda.gmm
    (3 K4 launches each), the Mamba cache leaves kept in f32, in f32
    within 1e-4 of the uncompiled naive decode, and in bf16 each step's
    argmax the uncompiled one's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.spec import leaves, tree_map

    cfg = get_arch("jamba-v0.1-52b").replace(
        n_layers=8, d_model=1024, n_heads=8, n_kv_heads=2, d_ff=2048,
        moe_decode_impl="naive_flat")
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg.replace(cache_dtype=dtype))
        params = model.init(torch.Generator(device=cuda).manual_seed(0),
                            cuda)
        if dtype == torch.float32:
            params = tree_map(lambda a: a.float(), params)
        fast = lilac.compile(model.decode, mode="host", device=cuda,
                             plan_cache="off", bake=False)
        cache = model.init_cache(2, 32, device=cuda)
        ref_cache = tree_map(lambda a: a.clone(), cache)
        for t in range(3):
            tok = torch.full((2, 1), 5 + t, dtype=torch.int32, device=cuda)
            pos = torch.tensor([t, t], dtype=torch.int32, device=cuda)
            K4.reset_launches()
            got, cache = fast(params, cache, tok, pos)
            torch.cuda.synchronize()
            body = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
            assert K4.LAUNCHES[body] == 12
            assert [n for _, n in fast.last_selections] == ["cuda.gmm"] * 4
            assert all(a.dtype == torch.float32 for k, a in leaves(cache)
                       if k.endswith(("ssm", "conv")))
            want, ref_cache = model.decode(params, ref_cache, tok, pos)
            if dtype == torch.float32:
                assert _rel(got, want) <= 1e-4
            else:
                assert torch.equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# a batch of vectors (torch.func.vmap over a compiled function)
# ---------------------------------------------------------------------------

def _vecs(cuda, dtype, b, cols, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, cols)).astype(
        np.float32)).to(cuda, dtype)


def _batched_against_solo(kernel, counter, run, vecs, plain, dtype):
    """One launch for the batch, each row bit for bit its vector's solo
    launch, and the batch within tolerance of the plain version."""
    before = K.LAUNCHES[counter]
    got = run(vecs)
    torch.cuda.synchronize()
    assert K.LAUNCHES[counter] == before + 1, kernel
    solo = torch.stack([run(v) for v in vecs])
    assert torch.equal(got, solo)
    torch.testing.assert_close(
        got, torch.stack([plain(v) for v in vecs]),
        **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("epilogue,with_bias,with_perm", EPILOGUES)
def test_k1_direct_batch_equals_solo_launches(cuda, dtype, b, epilogue,
                                              with_bias, with_perm):
    val, col, perm, _, bias = _ell(cuda, dtype)
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    _batched_against_solo(
        "K1 direct", "spmv_ell",
        lambda v: K.spmv_ell_cuda(val, col, v, **kw),
        _vecs(cuda, dtype, b, 3000),
        lambda v: R.spmv_ell_plain(val, col, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("body,window", [("spmv_ell_staged", 512),
                                         ("spmv_ell_staged", 3000),
                                         ("spmv_ell_windowed", 512)])
@pytest.mark.parametrize("epilogue,with_bias,with_perm", EPILOGUES)
def test_k1_staged_and_k2_batch_equal_solo_launches(
        cuda, dtype, b, body, window, epilogue, with_bias, with_perm):
    val, col, perm, _, bias = _ell(cuda, dtype)
    w = tf.ell_windows(val, col, 3000, window=window)
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    wrapper = getattr(K, body + "_cuda")
    _batched_against_solo(
        body, body, lambda v: wrapper(w, v, **kw),
        _vecs(cuda, dtype, b, 3000),
        lambda v: R.spmv_ell_windowed_plain(w, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 8])
def test_vmapped_custom_ops_launch_once_for_the_batch(cuda, b):
    """lilac_torch::spmv_ell and ::spmv_ell_layout under torch.func.vmap:
    one launch for the batch, equal to the loop bit for bit; a batched
    matrix launches once an element."""
    val, col, perm, _, bias = _ell(cuda, torch.float32)
    vecs = _vecs(cuda, torch.float32, b, 3000)
    f = lambda v: ell_ops.spmv_ell_op(val, col, v, bias, None, None, "relu",
                                      32)
    before = K.LAUNCHES["spmv_ell"]
    got = torch.func.vmap(f)(vecs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell"] == before + 1
    assert torch.equal(got, torch.stack([f(v) for v in vecs]))
    vals = torch.stack([val * (j + 1) for j in range(b)])
    g = lambda a: ell_ops.spmv_ell_op(a, col, vecs[0], None, None, None,
                                      None, 32)
    before = K.LAUNCHES["spmv_ell"]
    torch.func.vmap(g)(vals)
    assert K.LAUNCHES["spmv_ell"] == before + b
    csr = trandom.random_csr(777, 3000, 0.02, seed=9, skew=1.0)
    packed = ell_ops.pack_ell128(tf.CSR(csr.val.to(cuda), csr.col_ind.to(cuda),
                                        csr.row_ptr.to(cuda), csr.shape))
    h = lambda v: ell_ops.spmv_ell_packed(packed, v)
    before = K.LAUNCHES["spmv_ell_staged"]
    got = torch.func.vmap(h)(vecs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_staged"] == before + 1
    assert torch.equal(got, torch.stack([h(v) for v in vecs]))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 8, 40])
@pytest.mark.parametrize("epilogue,bias_kind", [(None, None),
                                                ("relu", "row")])
def test_k3_batch_of_vectors_as_columns(cuda, b, epilogue, bias_kind):
    """lilac_torch::bsr_spmm under vmap over vectors: one launch with the
    vectors as the operand's b columns (the narrow body up to 8, the wide
    one past it), within tolerance of the plain version."""
    packed = _packed(cuda, torch.float32)
    vecs = _vecs(cuda, torch.float32, b, 600)
    bias = torch.linspace(-1, 1, 700, device=cuda) if bias_kind else None
    f = lambda v: bsr_ops.bsr_spmm(packed, v[:, None], epilogue=epilogue,
                                   bias=bias, bias_kind=bias_kind,
                                   out_rows=700)[:, 0]
    body = _k3_body(b)
    before = K3.LAUNCHES[body]
    got = torch.func.vmap(f)(vecs)
    torch.cuda.synchronize()
    assert K3.LAUNCHES[body] == before + 1
    want = R3.bsr_spmm_plain(packed, vecs.T.contiguous(), out_rows=700,
                             bias=bias, bias_kind=bias_kind,
                             epilogue=epilogue).T
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_vmap_rule_against_the_loop(cuda, dtype):
    """lilac_torch::moe_ffn under vmap over 3 token groups: one call over
    their tokens (3 K4 launches, not 9), each token's row bit for bit the
    group's own call."""
    rng = np.random.default_rng(12)
    B, T, D, F, E, K_ = 3, 200, 128, 256, 8, 2
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(
        np.float32)).to(cuda, dtype)
    gate = torch.from_numpy(rng.random((B, T, K_)).astype(np.float32)).to(
        cuda)
    idx = torch.from_numpy(rng.integers(0, E, (B, T, K_)).astype(
        np.int32)).to(cuda)
    w = [torch.from_numpy((rng.standard_normal(s) * .05).astype(
        np.float32)).to(cuda, dtype)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    f = lambda a, g, i: gmm_ops.moe_ffn_op(a, g, i, *w, 128)
    key = "gmm" if dtype == torch.bfloat16 else "gmm_f32"
    before = K4.LAUNCHES[key]
    got = torch.func.vmap(f)(x, gate, idx)
    torch.cuda.synchronize()
    assert K4.LAUNCHES[key] == before + 3
    loop = torch.stack([f(x[j], gate[j], idx[j]) for j in range(B)])
    assert torch.equal(got, loop)


# ---------------------------------------------------------------------------
# plans under transforms: a vmapped call served by its batched plan
# ---------------------------------------------------------------------------

def _naive_spmv_oop(val, col, row_ptr, v):
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    return torch.zeros(rows, dtype=val.dtype, device=val.device).index_add(
        0, row, val * v[col])


def _moe_groups(cuda, B=3, T=200, D=128, F=256, E=8, K_=2, seed=13):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    gate = torch.from_numpy(rng.random((B, T, K_)).astype(np.float32)).to(
        cuda)
    idx = torch.from_numpy(rng.integers(0, E, (B, T, K_)).astype(
        np.int32)).to(cuda)
    w = [torch.from_numpy((rng.standard_normal(s) * .05).astype(
        np.float32)).to(cuda, torch.bfloat16)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, gate, idx, w


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["K1 staged", "K2", "K3 narrow", "K4"])
def test_batched_plan_replay_equals_the_unplanned_vmapped_call(
        cuda, case, monkeypatch):
    """A vmapped call bakes a batched plan; the next call is a plan hit
    whose replay (a CUDA graph, or its program run eagerly, as the bake's
    timing chose) launches the kernel once for the batch (K4 3 times) and
    equals, bit for bit, the same call through a function compiled with
    bake=False."""
    if case == "K2":
        # a vector past the limit: the windowed body's layout and launch
        monkeypatch.setattr(ell_ops, "RESIDENT_VEC_LIMIT", 1000)
    if case == "K4":
        x, gate, idx, w = _moe_groups(cuda)
        counters, body = K4.LAUNCHES, "gmm"

        def call(f):
            return torch.func.vmap(lambda a, g, i: f(a, g, i, *w))(
                x, gate, idx)

        kw = dict(policy="cuda.gmm")
        fn = tlayers._moe_naive_2d
    else:
        csr = trandom.random_csr(777, 3000, 0.02, seed=9, skew=1.0)
        val, col, ptr = (t.to(cuda) for t in (csr.val, csr.col_ind,
                                              csr.row_ptr))
        vecs = _vecs(cuda, torch.float32, 8, 3000)
        counters, body = {"K1 staged": (K.LAUNCHES, "spmv_ell_staged"),
                          "K2": (K.LAUNCHES, "spmv_ell_windowed"),
                          "K3 narrow": (K3.LAUNCHES, "bsr_spmm_narrow")}[case]

        def call(f):
            return torch.func.vmap(lambda v: f(val, col, ptr, v))(vecs)

        kw = dict(mode="host", policy="cuda.bcsr" if case == "K3 narrow"
                  else "cuda.ell")
        fn = _naive_spmv_oop
    fast = lilac.compile(fn, device=cuda, **kw)
    slow = lilac.compile(fn, device=cuda, bake=False, **kw)
    first = call(fast)
    before = counters[body]
    served = call(fast)
    torch.cuda.synchronize()
    assert counters[body] - before == (3 if case == "K4" else 1)
    info = fast.plan_info()
    assert info["plan_hits"] == 1 and not info["bake_errors"], info
    (plan,) = info["plans"]
    assert plan["transform"]["vmap"] and not plan["transform"]["grad"]
    want = call(slow)
    assert slow.plan_info()["baked"] == 0
    assert torch.equal(served, want) and torch.equal(first, want)


@pytest.mark.gpu
def test_gradient_carrying_batched_plan_on_k4(cuda):
    """The training step's MoE call: vmapped over token groups, its
    activations and weights requiring grad.  The second call is a hit on
    a batched plan run eagerly (no CUDA graph: a replay records no
    autograd graph), with 3 K4 launches, and its value and gradients equal
    the bake=False function's bit for bit."""
    x, gate, idx, w = _moe_groups(cuda)

    def run(f):
        xs = x.detach().clone().requires_grad_()
        ws = [t.detach().clone().requires_grad_() for t in w]
        out = torch.func.vmap(lambda a, g, i: f(a, g, i, *ws))(xs, gate, idx)
        out.float().square().sum().backward()
        return [out.detach(), xs.grad] + [t.grad for t in ws]

    fast = lilac.compile(tlayers._moe_naive_2d, policy="cuda.gmm",
                         device=cuda)
    slow = lilac.compile(tlayers._moe_naive_2d, policy="cuda.gmm",
                         device=cuda, bake=False)
    run(fast)
    before = K4.LAUNCHES["gmm"]
    got = run(fast)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] - before == 3
    info = fast.plan_info()
    (plan,) = info["plans"]
    assert info["plan_hits"] == 1 and plan["runs"] == "eager"
    assert plan["transform"]["grad"] and plan["transform"]["vmap"]
    want = run(slow)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
