"""The CUDA ELL kernels on the card, against their plain torch versions.

Every test is marked ``gpu`` and skips where no CUDA card is present.  This
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import lilac
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ref as R
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
