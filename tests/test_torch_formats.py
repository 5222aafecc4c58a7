"""The port's sparse containers and constructors against the JAX package:
the same numpy inputs must give byte-identical arrays, and the reference
SpMVs must agree.  Also the CSR generators that build solver-sized
matrices directly, checked at small sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import formats as jf
from repro.sparse import ops as jops
from repro.sparse import random as jrandom
from repro_torch.sparse import formats as tf
from repro_torch.sparse import ops as tops
from repro_torch.sparse import random as trandom

CASES = [
    (200, 300, 0.05, 0.0),
    (64, 64, 0.2, 0.0),
    (512, 128, 0.02, 1.0),      # power-law rows (graph-like)
    (9, 5, 0.0, 0.0),           # all-zero matrix
]


def _same(torch_c, jax_c):
    got = tf.to_numpy(torch_c)
    for name, arr in got.items():
        ref = getattr(jax_c, name)
        if name in ("shape", "block_shape"):
            assert tuple(arr) == tuple(ref)
            continue
        ref = np.asarray(ref)
        assert arr.dtype == ref.dtype, name
        assert arr.shape == ref.shape, name
        assert arr.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("rows,cols,density,skew", CASES)
def test_random_csr_and_dense_constructors_byte_identical(rows, cols, density,
                                                          skew):
    _same(trandom.random_csr(rows, cols, density, seed=rows, skew=skew),
          jrandom.random_csr(rows, cols, density, seed=rows, skew=skew))
    d = jrandom.random_dense_sparse(rows, cols, density, seed=1)
    _same(tf.coo_from_dense(d), jf.coo_from_dense(d))


@pytest.mark.parametrize("lane", [8, 128])
@pytest.mark.parametrize("rows,cols,density,skew", CASES)
def test_ell_from_csr_byte_identical(rows, cols, density, skew, lane):
    """The vectorised ell_from_csr against the reference's row loop."""
    ref = jrandom.random_csr(rows, cols, density, seed=rows, skew=skew)
    csr = tf.from_numpy(ref)
    _same(tf.ell_from_csr(csr, lane=lane), jf.ell_from_csr(ref, lane=lane))
    _same(tf.ell_from_csr(csr, width=40, sort_rows=False),
          jf.ell_from_csr(ref, width=40, sort_rows=False))


@pytest.mark.parametrize("rows,cols,density,skew", CASES)
def test_jds_from_csr_byte_identical(rows, cols, density, skew):
    ref = jrandom.random_csr(rows, cols, density, seed=rows, skew=skew)
    _same(tf.jds_from_csr(tf.from_numpy(ref)), jf.jds_from_csr(ref))


def test_numpy_interchange_round_trip():
    ref = jrandom.random_csr(40, 30, 0.1, seed=2)
    csr = tf.from_numpy(ref)
    assert csr.val.dtype == torch.float32 and csr.col_ind.dtype == torch.int32
    back = tf.from_numpy(tf.to_numpy(csr), kind="CSR")
    _same(back, ref)
    bref = jrandom.random_bcsr(256, 384, (128, 128), 0.3, seed=2)
    bcsr = tf.from_numpy(bref)
    assert bcsr.block_shape == (128, 128) and bcsr.nblocks == bref.nblocks
    _same(tf.from_numpy(tf.to_numpy(bcsr), kind="BCSR"), bref)
    with pytest.raises(TypeError):
        tf.from_numpy(ref, kind="DIA")


def test_todense_and_reference_spmvs_match_jax():
    ref = jrandom.random_csr(70, 50, 0.1, seed=4, skew=1.0)
    csr = tf.from_numpy(ref)
    np.testing.assert_array_equal(csr.todense().numpy(), np.asarray(ref.todense()))
    v = np.random.default_rng(5).standard_normal(50).astype(np.float32)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    np.testing.assert_allclose(tops.spmv_csr_ref(csr, tv).numpy(),
                               np.asarray(jops.spmv_csr_ref(ref, jv)),
                               atol=1e-5, rtol=1e-5)
    ell_ref = jf.ell_from_csr(ref)
    np.testing.assert_allclose(
        tops.spmv_ell_ref(tf.ell_from_csr(csr), tv).numpy(),
        np.asarray(jops.spmv_ell_ref(ell_ref, jv)), atol=1e-5, rtol=1e-5)
    d = np.asarray(ref.todense())
    coo_ref = jf.coo_from_dense(d)
    np.testing.assert_allclose(
        tops.spmv_coo_ref(tf.coo_from_dense(d), tv).numpy(),
        np.asarray(jops.spmv_coo_ref(coo_ref, jv)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [8, 16, 128])
def test_ell_windows_layout(window):
    """Every stored entry lands once in its column window with a
    window-local id, and the layout is no wider than needed."""
    ref = jrandom.random_csr(60, 100, 0.15, seed=6, skew=1.0)
    ell = tf.ell_from_csr(tf.from_numpy(ref))
    w = tf.ell_windows(ell.val, ell.col, 100, window=window)
    assert w.n_windows == -(-100 // window) and w.window == window
    dense = np.zeros((60, w.n_windows * window), np.float32)
    v3, c3 = w.val.numpy(), w.col.numpy()
    for i, wi, k in zip(*np.nonzero(v3)):
        dense[i, wi * window + c3[i, wi, k]] += v3[i, wi, k]
    expect = np.zeros((60, 100), np.float32)
    rows = np.repeat(np.arange(60), ell.width)
    np.add.at(expect, (rows, ell.col.numpy().reshape(-1)),
              ell.val.numpy().reshape(-1))
    np.testing.assert_array_equal(dense[:, :100], expect)
    assert not dense[:, 100:].any()
    per_group = (v3 != 0).sum(axis=2).max()
    assert w.width == max(8, -(-per_group // 8) * 8)


def test_stencil27_is_hpcg_operator():
    csr = trandom.stencil27_csr(4, 3, 5)
    d = csr.todense().numpy()
    assert d.shape == (60, 60)
    np.testing.assert_array_equal(np.diag(d), 26.0)
    np.testing.assert_array_equal(d, d.T)
    # an interior point of a 3-D grid has all 26 neighbours
    interior = 1 + 4 * (1 + 3 * 2)
    assert np.diff(csr.row_ptr.numpy())[interior] == 27
    # columns ascend within each row; HPCG's b = A @ ones
    rp, col = csr.row_ptr.numpy(), csr.col_ind.numpy()
    assert all(np.all(np.diff(col[rp[i]:rp[i + 1]]) > 0) for i in range(60))
    np.testing.assert_array_equal(d.sum(axis=1),
                                  26.0 - (np.diff(rp) - 1))


def test_random_spd_is_symmetric_diagonally_dominant():
    csr = trandom.random_spd_csr(300, 12, seed=3)
    d = csr.todense().numpy().astype(np.float64)
    np.testing.assert_array_equal(d, d.T)
    off = np.abs(d).sum(axis=1) - np.abs(np.diag(d))
    assert np.all(np.diag(d) > off)
    assert 9 <= csr.nnz / 300 <= 12
    again = trandom.random_spd_csr(300, 12, seed=3)
    assert torch.equal(again.val, csr.val) and torch.equal(again.col_ind,
                                                           csr.col_ind)
