"""The port's ELL SpMV ops layer against the JAX package's Pallas kernels
(run in interpret mode, as tests/test_kernels.py runs them), at the
reference's own tolerance (atol = rtol = 1e-4).  On the CPU the wrappers
take the kernels' plain versions; tests/test_torch_kernels_gpu.py holds
the CUDA kernels themselves against those plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmv_ell import ops as ref_ops
from repro.sparse import ell_from_csr, random_csr
from repro_torch.kernels.spmv_ell import kernel as K
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.kernels.spmv_ell import ref as R
from repro_torch.sparse import formats as tf

TOL = dict(atol=1e-4, rtol=1e-4)


def _operands(rows, cols, density, skew, seed=3):
    ell = ell_from_csr(random_csr(rows, cols, density=density, seed=rows,
                                  skew=skew))
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal(cols).astype(np.float32)
    bias = rng.standard_normal(rows).astype(np.float32)
    t = tf.from_numpy(ell)
    return ell, t, vec, bias


@pytest.mark.parametrize("rows,cols,density,skew", [
    (200, 300, 0.05, 0.0),
    (64, 64, 0.2, 0.0),
    (512, 128, 0.02, 1.0),      # power-law rows (graph-like)
])
def test_spmv_ell_resident_matches_pallas(rows, cols, density, skew):
    ell, t, vec, _ = _operands(rows, cols, density, skew)
    ref = ref_ops.spmv_ell(ell.val, ell.col, jnp.asarray(vec), interpret=True)
    out = ell_ops.spmv_ell(t.val, t.col, torch.from_numpy(vec))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("epilogue,with_bias", [
    ("relu", True), ("silu", False), ("silu", True), ("none", True),
])
def test_spmv_ell_epilogues_match_pallas(epilogue, with_bias):
    ell, t, vec, bias = _operands(200, 300, 0.05, 0.0)
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    ref = ref_ops.spmv_ell(ell.val, ell.col, jnp.asarray(vec),
                           epilogue=epilogue, bias=jb, interpret=True)
    out = ell_ops.spmv_ell(t.val, t.col, torch.from_numpy(vec),
                           epilogue=epilogue, bias=tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_spmv_ell_scalar_bias_applies_unfused():
    ell, t, vec, _ = _operands(64, 64, 0.2, 0.0)
    ref = ref_ops.spmv_ell(ell.val, ell.col, jnp.asarray(vec),
                           epilogue="relu", bias=jnp.float32(0.25),
                           interpret=True)
    out = ell_ops.spmv_ell(t.val, t.col, torch.from_numpy(vec),
                           epilogue="relu", bias=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("epilogue", [None, "relu"])
def test_spmv_ell_windowed_matches_pallas(epilogue):
    """The windowed kernel's layout at window=128, as the reference's own
    windowed test runs it."""
    ell = ell_from_csr(random_csr(128, 512, density=0.05, seed=11))
    vec = np.random.default_rng(4).standard_normal(512).astype(np.float32)
    bias = np.random.default_rng(5).standard_normal(128).astype(np.float32)
    jb = None if epilogue is None else jnp.asarray(bias)
    tb = None if epilogue is None else torch.from_numpy(bias)
    ref = ref_ops._windowed(ell.val, ell.col, jnp.asarray(vec), 8, True,
                            window=128, epilogue=epilogue, bias=jb)
    t = tf.from_numpy(ell)
    out = ell_ops._windowed(t.val, t.col, torch.from_numpy(vec), 8,
                            window=128, epilogue=epilogue, bias=tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:128], **TOL)


@pytest.mark.parametrize("cols", [300, 1_100_000])
def test_spmv_ell_packed_unpermutes_like_the_reference(cols):
    """Marshaled ELL: the kernel's store un-permutes the row sort and the
    fused epilogue indexes the bias by output row.  For a vector over 1<<20
    elements the marshaled value is the matrix's column-window relayout
    alone, and the windowed kernel runs on it."""
    rng = np.random.default_rng(7)
    key = np.unique(rng.integers(0, 96 * cols, 900))
    r, c = key // cols, key % cols
    v = rng.standard_normal(key.shape[0]).astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=96))])
    csr = tf.CSR(val=torch.from_numpy(v),
                 col_ind=torch.from_numpy(c.astype(np.int32)),
                 row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
                 shape=(96, cols))
    vec = rng.standard_normal(cols).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    expect = np.zeros(96, np.float64)
    np.add.at(expect, r, v.astype(np.float64) * vec[c])
    expect = np.maximum(expect + bias, 0)
    packed = ell_ops.pack_ell128(csr)
    out = ell_ops.spmv_ell_packed(packed, torch.from_numpy(vec),
                                  epilogue="relu", bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), expect, **TOL)
    assert isinstance(packed, tf.WindowedELL) == (cols > 1 << 20)
    ell = tf.ell_from_csr(csr, lane=128)
    assert torch.equal(packed.perm, ell.perm)


@pytest.mark.parametrize("rows,rps,expect", [
    (200, 256, (128, 256)),     # fewer rows than a slab: clamp
    (5, 256, (8, 8)),
    (1000, 256, (256, 1024)),
    (1000, 32, (32, 1024)),
    (64, 64, (64, 64)),
])
def test_slab_geometry_matches_reference_padding(rows, rps, expect):
    """ops.py:51-54 of the reference: pad to the slab, clamp tiny counts."""
    assert ell_ops.slab_geometry(rows, rps) == expect


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """CPU tensors -> the plain version; anything else must not fall back."""
    _, t, vec, _ = _operands(64, 64, 0.2, 0.0)
    v = torch.from_numpy(vec)
    before = dict(K.LAUNCHES)
    out = K.spmv_ell_cuda(t.val, t.col, v)
    torch.testing.assert_close(out, R.spmv_ell_ref(t.val, t.col, v))
    assert K.LAUNCHES == before          # the plain version is no launch
    with pytest.raises(ValueError):
        K.spmv_ell_cuda(t.val.to("meta"), t.col.to("meta"), v.to("meta"))
