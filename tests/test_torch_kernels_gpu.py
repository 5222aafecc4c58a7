"""The CUDA kernels on the card (ELL SpMV K1 in its staged and direct
bodies and K2, BCSR SpMM K3 in its wide and narrow bodies over packed
tiles, grouped matmul K4), against their plain torch versions.

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

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # bf16 storage, f32 accumulation


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
    before = K4.LAUNCHES["gmm"]
    got = K4.gmm_cuda(xs, w, te, tm=tm)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] == before + 1
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
    one K3 launch a call), moe_ffn on cuda.gmm (three K4 launches a call)."""
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

    fast = lilac.compile(layer)
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
    before = K4.LAUNCHES["gmm"]
    got, _ = tlayers.moe_block(p, x, topk=2, impl="lilac")
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] == before + 6
    fast = tlayers._lilac_moe_2d("cuda")
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    want, _ = tlayers.moe_block(p, x, topk=2, impl="naive")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_compiled_bf16_moe_runs_the_tensor_core_kernel(cuda):
    """The MoE path in bf16, as OLMoE runs it: moe_ffn on cuda.gmm, three
    launches of K4's tensor-core body a sequence, within bf16 rounding of
    the f32 oracle (relative L2 error, as chip_smoke.py states it)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = tlayers.moe_params(tlayers.moe_spec(64, 32, 8, torch.bfloat16), gen)
    x = torch.randn(2, 40, 64, generator=gen, device=cuda).bfloat16()
    before = K4.LAUNCHES["gmm"]
    got, _ = tlayers.moe_block(p, x, topk=2, impl="lilac")
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] == before + 6
    fast = tlayers._lilac_moe_2d("cuda")
    assert [n for _, n in fast.last_selections] == ["cuda.gmm"]
    gate, idx, _ = tlayers.moe_router(p, x, 2)
    for b in range(2):
        want = R4.moe_ffn_ref(x[b], gate[b], idx[b], p["wg"], p["wu"],
                              p["wd"])
        err = torch.linalg.vector_norm(got[b].float() - want) \
            / torch.linalg.vector_norm(want)
        assert got.dtype == torch.bfloat16 and float(err) <= 2e-2
