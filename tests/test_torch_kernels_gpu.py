"""The CUDA kernels on the card (ELL SpMV K1/K2, BCSR SpMM K3, grouped
matmul K4), against their plain torch versions.

Every test is marked ``gpu`` and skips where no CUDA card is present.  This
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import lilac
from repro_torch.kernels.bsr_spmm import kernel as K3
from repro_torch.kernels.bsr_spmm import ref as R3
from repro_torch.kernels.moe_gmm import kernel as K4
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as R4
from repro_torch.kernels.spmv_ell import kernel as K
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
    assert w.n_windows == 6
    kw = dict(bias=bias if with_bias else None,
              perm=perm if with_perm else None, epilogue=epilogue)
    before = K.LAUNCHES["spmv_ell_windowed"]
    got = K.spmv_ell_windowed_cuda(w.val, w.col, vec, window=512, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell_windowed"] == before + 1
    torch.testing.assert_close(
        got, R.spmv_ell_windowed_plain(w.val, w.col, vec, window=512, **kw),
        **(TOL if dtype == torch.float32 else BF16_TOL))


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
    with pytest.raises(ValueError):
        K.spmv_ell_windowed_cuda(val.view(8, 2, 8), col.view(8, 2, 8), vec,
                                 window=4)


@pytest.mark.gpu
def test_compiled_csr_spmv_runs_the_kernel(cuda):
    """The host-mode path on the card: detect, repack once, launch K1."""
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
    before = K.LAUNCHES["spmv_ell"]
    for _ in range(3):
        out = fast(csr.val, csr.col_ind, csr.row_ptr, v)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_ell"] == before + 3
    assert fast.cache.stats.misses == 1
    assert [n for _, n in fast.last_selections] == ["cuda.ell"]
    torch.testing.assert_close(out, naive(csr.val, csr.col_ind, csr.row_ptr,
                                          v), **TOL)


def _bcsr(cuda, dtype, bm=128, rows=700, cols=600, density=0.03, seed=4):
    """A BCSR of a random matrix with its block rows 1 (and 3) empty."""
    d = trandom.random_dense_sparse(rows, cols, density, seed=seed)
    d[bm:2 * bm] = 0
    if rows > 4 * bm:
        d[3 * bm:4 * bm] = 0
    b = tconvert.csr_to_bcsr(tf.csr_from_dense(d), (bm, 128))
    return tf.BCSR(b.blocks.to(cuda, dtype), b.block_col.to(cuda),
                   b.block_rowptr.to(cuda), b.shape, b.block_shape)


K3_CASES = [(None, None), ("relu", "row"), ("silu", "col"), ("none", "row"),
            ("none", "col"), ("relu", None), ("silu", "row"), ("relu", "col")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue,bias_kind", K3_CASES)
@pytest.mark.parametrize("n", [1, 128, 200])
def test_bsr_spmm_kernel_matches_plain(cuda, dtype, epilogue, bias_kind, n):
    """Every epilogue and bias kind, empty block rows, N = 1 (the SpMV
    harness's width), 128 and a ragged 200, a dense operand shorter than
    the padded columns, and rows cut short of the last block row."""
    b = _bcsr(cuda, dtype)
    rng = np.random.default_rng(2)
    dense = torch.from_numpy(rng.standard_normal((590, n)).astype(
        np.float32)).to(cuda, dtype)
    rows = 690
    bias = None if bias_kind is None else torch.from_numpy(
        rng.standard_normal(rows if bias_kind == "row" else n)
        .astype(np.float32)).to(cuda)
    kw = dict(out_rows=rows, bias=bias, bias_kind=bias_kind,
              epilogue=epilogue)
    before = K3.LAUNCHES["bsr_spmm"]
    got = K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense, **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["bsr_spmm"] == before + 1
    want = R3.bsr_spmm_plain(b.blocks, b.block_col, b.block_rowptr, dense,
                             **kw)
    assert got.shape == (rows, n)
    torch.testing.assert_close(got, want, **(TOL if dtype == torch.float32
                                             else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [8, 64])
def test_bsr_spmm_kernel_short_tiles(cuda, bm):
    b = _bcsr(cuda, torch.float32, bm=bm, rows=512, cols=384, density=0.1)
    dense = torch.randn(384, 64, device=cuda)
    got = K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense,
                           epilogue="relu")
    want = R3.bsr_spmm_plain(b.blocks, b.block_col, b.block_rowptr, dense,
                             epilogue="relu")
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tp,D,F,E,tm", [
    (256, 128, 256, 4, 128),
    (96, 96, 192, 4, 16),       # _tile clamps fn to 64
    (64, 64, 128, 8, 8),
    (512, 64, 128, 2, 256),     # a tile taller than a CTA
])
def test_gmm_kernel_matches_plain(cuda, dtype, Tp, D, F, E, tm):
    rng = np.random.default_rng(Tp + D)
    xs = torch.from_numpy(rng.standard_normal((Tp, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32))
    te = torch.from_numpy(rng.integers(0, E, Tp // tm).astype(np.int32))
    xs, w, te = xs.to(cuda, dtype), w.to(cuda, dtype), te.to(cuda)
    before = K4.LAUNCHES["gmm"]
    got = K4.gmm_cuda(xs, w, te, tm=tm, fn=gmm_ops._tile(F))
    torch.cuda.synchronize()
    assert K4.LAUNCHES["gmm"] == before + 1
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, tm),
                               **(TOL if dtype == torch.float32
                                  else dict(atol=2e-2, rtol=2e-2)))


@pytest.mark.gpu
def test_gmm_kernel_takes_out_of_range_expert_ids_as_plain(cuda):
    """Expert ids past E or below 0 read no weight past w: the kernel maps
    them as its plain version does (negative from the end, then clamped)."""
    rng = np.random.default_rng(5)
    E = 3
    xs = torch.from_numpy(rng.standard_normal((80, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, 32, 64)).astype(np.float32))
    xs, w = xs.to(cuda), w.to(cuda)
    te = torch.tensor([E, -1, E + 1000, -E - 1000, 1], dtype=torch.int32,
                      device=cuda)
    got = K4.gmm_cuda(xs, w, te, tm=16, fn=64)
    torch.cuda.synchronize()
    in_range = torch.tensor([E - 1, E - 1, E - 1, 0, 1], dtype=torch.int32,
                            device=cuda)
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, in_range, 16), **TOL)
    torch.testing.assert_close(got, R4.gmm_ref(xs, w, te, 16), **TOL)


@pytest.mark.gpu
def test_k3_k4_wrappers_refuse_bad_operands(cuda):
    b = _bcsr(cuda, torch.float32)
    dense = torch.randn(600, 8, device=cuda)
    with pytest.raises(TypeError):
        K3.bsr_spmm_cuda(b.blocks, b.block_col.long(), b.block_rowptr, dense)
    with pytest.raises(TypeError):
        K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense.half())
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense,
                         bias=torch.ones(3, device=cuda), bias_kind="col")
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense,
                         bias=torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        K3.bsr_spmm_cuda(b.blocks, b.block_col, b.block_rowptr, dense.t())
    xs = torch.randn(256, 64, device=cuda)
    w = torch.randn(2, 64, 128, device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs, w, te, tm=128, fn=256)
    with pytest.raises(ValueError):
        K4.gmm_cuda(xs, w, te, tm=96, fn=128)
    with pytest.raises(TypeError):
        K4.gmm_cuda(xs, w.bfloat16(), te, tm=128, fn=128)


@pytest.mark.gpu
def test_compiled_spmm_and_moe_run_their_kernels(cuda):
    """The default policy on the card: spmm_csr on cuda.bcsr (one repack,
    one K3 launch a call), moe_ffn on cuda.gmm (three K4 launches a call)."""
    csr = tf.from_numpy(tf.to_numpy(trandom.random_csr(300, 200, 0.05,
                                                       seed=2)),
                        kind="CSR", device=cuda)
    h = torch.randn(200, 16, device=cuda)
    bias = torch.randn(16, device=cuda)

    def layer(val, col, row_ptr, h, bias):
        rows = row_ptr.shape[0] - 1
        r = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                    torch.diff(row_ptr),
                                    output_size=val.shape[0])
        out = torch.zeros(rows, h.shape[1], device=val.device)
        return torch.relu(out.index_add_(0, r, val[:, None] * h[col]) + bias)

    fast = lilac.compile(layer)
    before = K3.LAUNCHES["bsr_spmm"]
    for _ in range(3):
        out = fast(csr.val, csr.col_ind, csr.row_ptr, h, bias)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["bsr_spmm"] == before + 3
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
