"""The port's sparse containers and constructors against the JAX package:
the same numpy inputs must give byte-identical arrays, and the reference
SpMVs must agree.  Also the CSR generators that build solver-sized
matrices directly, checked at small sizes."""
import dataclasses

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


def _check_windowed_layout(w, val, col, window):
    """The slab-compacted column-window layout against the ELL it came
    from, in numpy: every stored entry appears once, in its (slab, window)
    segment, with its window-local id; no empty segment is stored; each
    segment is as wide as its slab's largest count in the window, rounded
    up to 8; and the slots are 32 x the sum of the widths."""
    v, c = val.numpy(), col.numpy()
    n_slabs = -(-v.shape[0] // 32)
    seg_ptr, seg_window = w.seg_ptr.numpy(), w.seg_window.numpy()
    seg_offset = w.seg_offset.numpy()
    lv, lc = w.val.numpy(), w.col.numpy().astype(np.int64)
    assert w.col.dtype == torch.uint16 and w.n_slabs == n_slabs
    assert seg_ptr[0] == 0 and seg_ptr[-1] == w.n_segments
    assert seg_offset[0] == 0 and seg_offset[-1] == lv.shape[0]
    r, j = np.nonzero(v)
    count = {}
    for ri, wi in zip(r, c[r, j] // window):
        count[ri, wi] = count.get((ri, wi), 0) + 1
    most = {}
    for (ri, wi), n in count.items():
        most[ri // 32, wi] = max(most.get((ri // 32, wi), 0), n)
    dense = np.zeros((n_slabs * 32, w.n_windows * window), np.float64)
    widths = []
    for b in range(n_slabs):
        segs = range(seg_ptr[b], seg_ptr[b + 1])
        assert [seg_window[s] for s in segs] == \
            sorted(wi for bb, wi in most if bb == b)
        for s in segs:
            width = -(-most[b, seg_window[s]] // 8) * 8
            assert seg_offset[s + 1] - seg_offset[s] == 32 * width
            widths.append(width)
            sv = lv[seg_offset[s]:seg_offset[s + 1]].reshape(width, 32)
            sc = lc[seg_offset[s]:seg_offset[s + 1]].reshape(width, 32)
            assert sv.any() and (sc < window).all()
            k, i = np.nonzero(sv)
            np.add.at(dense, (b * 32 + i, seg_window[s] * window + sc[k, i]),
                      sv[k, i])
    assert lv.shape[0] == 32 * sum(widths)
    assert np.count_nonzero(lv) == r.shape[0]
    expect = np.zeros_like(dense)
    np.add.at(expect, (r, c[r, j]), v[r, j])
    np.testing.assert_array_equal(dense, expect)


@pytest.mark.parametrize("window", [8, 16, 128])
def test_ell_windows_layout(window):
    """60 rows (a ragged second slab) of skewed rows over 100 columns, in
    13, 7 and 1 column windows."""
    ref = jrandom.random_csr(60, 100, 0.15, seed=6, skew=1.0)
    ell = tf.ell_from_csr(tf.from_numpy(ref))
    w = tf.ell_windows(ell.val, ell.col, 100, window=window, perm=ell.perm)
    assert w.n_windows == -(-100 // window) and w.window == window
    assert w.shape == (60, 100) and w.perm is ell.perm
    _check_windowed_layout(w, ell.val, ell.col, window)


def test_ell_windows_layout_of_the_stencil():
    """HPCG's operator on an 8^3 grid, marshaled as the SpMV path does it
    (lane-128 ELL, JDS row sort), in windows of one 8x8 plane: a slab's
    rows touch the planes of their neighbours, and each slab stores a
    segment for exactly the windows its rows touch."""
    from repro_torch.sparse.convert import csr_to_ell

    csr = trandom.stencil27_csr(8, 8, 8)
    ell = csr_to_ell(csr, lane=128)
    w = tf.ell_windows(ell.val, ell.col, csr.cols, window=64, perm=ell.perm)
    _check_windowed_layout(w, ell.val, ell.col, 64)
    c = ell.col.numpy()
    touched = [np.unique(c[b * 32:(b + 1) * 32][ell.val.numpy()[
        b * 32:(b + 1) * 32] != 0] // 64).shape[0] for b in range(16)]
    assert torch.diff(w.seg_ptr).tolist() == touched
    assert min(touched) >= 2 and w.n_segments == sum(touched)


def _spoil(w, case):
    """The fields of ``w`` changed so that one segment reads out of bounds."""
    off, ptr = w.seg_offset.clone(), w.seg_ptr.clone()
    win, col = w.seg_window.clone(), w.col.clone()
    if case == "slots_end_past_val":
        return dict(val=w.val[:-32], col=w.col[:-32])
    if case == "offsets_shrink":
        off[1] = off[2] + 32
        return dict(seg_offset=off)
    if case == "ptr_ends_short":
        ptr[-1] -= 1
        return dict(seg_ptr=ptr)
    if case == "window_past_the_last":
        win[0] = w.n_windows
        return dict(seg_window=win)
    if case == "id_past_its_window":
        col[0] = w.window
        return dict(col=col)
    # the last window holds columns 96-99: local id 4 is column 100
    s = int(torch.nonzero(w.seg_window == w.n_windows - 1)[0])
    col[int(w.seg_offset[s])] = 4
    return dict(col=col)


@pytest.mark.parametrize("case", [
    "slots_end_past_val", "offsets_shrink", "ptr_ends_short",
    "window_past_the_last", "id_past_its_window", "id_past_the_columns"])
def test_windowed_layout_refuses_out_of_bounds_segments(case):
    """The windowed kernel follows the segments unchecked, so building a
    layout whose segments would read past its slots, its windows or the
    matrix's columns raises, on any device."""
    ref = jrandom.random_csr(60, 100, 0.15, seed=6, skew=1.0)
    ell = tf.ell_from_csr(tf.from_numpy(ref))
    w = tf.ell_windows(ell.val, ell.col, 100, window=16, perm=ell.perm)
    assert dataclasses.replace(w).n_segments == w.n_segments
    with pytest.raises(ValueError):
        dataclasses.replace(w, **_spoil(w, case))


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


# ---------------------------------------------------------------------------
# The packed BCSR layout (K3's)
# ---------------------------------------------------------------------------

def _edge_case_csr(rows, cols, dtype=torch.float32):
    """A CSR with a duplicate entry, an explicit stored zero, a duplicate
    pair that sums to zero, an empty block row at 8-row tiles (rows
    8..15) and ragged edges."""
    d = np.asarray(jrandom.random_dense_sparse(rows, cols, 0.1, seed=rows))
    d[8:16] = 0
    r, c = np.nonzero(d)
    v = d[r, c]
    r = np.concatenate([r, [0, 1, 2, 2]])
    c = np.concatenate([c, [c[0], cols - 1, 3, 3]])
    v = np.concatenate([v, [0.5, 0.0, 0.25, -0.25]]).astype(np.float32)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=rows))])
    return tf.CSR(torch.from_numpy(v).to(dtype),
                  torch.from_numpy(c.astype(np.int32)),
                  torch.from_numpy(row_ptr.astype(np.int32)), (rows, cols))


def _check_packed(p, csr):
    """The packed layout's properties against the CSR it came from."""
    from repro_torch.sparse.convert import csr_to_bcsr

    bm, bk = p.block_shape
    rows, cols = csr.shape
    # todense: duplicates summed, explicit zeros (and zero sums) dropped
    dense = p.todense()
    assert dense.dtype == csr.val.dtype
    assert torch.equal(dense[:rows, :cols], csr.todense())
    assert not dense[rows:].any() and not dense[:, cols:].any()
    assert bool((p.val != 0).all())
    assert p.nnz == int((csr.todense() != 0).sum())
    # the outer structure is csr_to_bcsr's, tile for tile
    b = csr_to_bcsr(csr, (bm, bk))
    assert p.shape == b.shape and p.block_shape == b.block_shape
    assert torch.equal(p.block_col, b.block_col)
    assert torch.equal(p.block_rowptr, b.block_rowptr)
    assert bool((torch.diff(p.block_rowptr) > 0).all())   # no empty row
    # and the entries are those dense tiles' entries, in the same order
    q = tf.pack_bcsr(b)
    for f in ("val", "tile_ptr", "col_mask", "block_col", "block_rowptr"):
        assert torch.equal(getattr(p, f), getattr(q, f)), f
    for f in ("local", "row_start"):
        assert torch.equal(getattr(p, f).long(), getattr(q, f).long()), f
    # local ids within the tile and strictly increasing in each tile
    ptr = p.tile_ptr.numpy()
    loc = p.local.numpy().astype(np.int64)
    assert p.local.dtype == torch.uint16 and (loc < bm * bk).all()
    for t in range(p.nblocks):
        seg = loc[ptr[t]:ptr[t + 1]]
        assert (np.diff(seg) > 0).all()
        starts = np.searchsorted(seg // bk, np.arange(bm))
        np.testing.assert_array_equal(p.row_start.numpy()[t], starts)
        # the column mask marks exactly the tile's columns
        words = p.col_mask.numpy()[t].astype(np.uint32)
        marked = [k for k in range(bk) if words[k // 32] >> (k % 32) & 1]
        assert marked == sorted(set((seg % bk).tolist()))
    # bytes: the entries at 2 + 2 or 4 + 2 B, then the offsets and masks
    assert p.val.nbytes + p.local.nbytes \
        == p.nnz * (p.val.element_size() + 2)
    assert p.tile_ptr.nbytes + p.row_start.nbytes + p.col_mask.nbytes \
        == 8 * (p.nblocks + 1) + 2 * p.nblocks * bm \
        + 4 * p.nblocks * -(-bk // 32)


@pytest.mark.parametrize("block_shape", [(8, 128), (128, 128), (64, 32),
                                         (16, 8)])
@pytest.mark.parametrize("rows,cols", [(45, 300), (130, 129), (16, 128)])
def test_packed_bcsr_layout(rows, cols, block_shape):
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    csr = _edge_case_csr(rows, cols)
    _check_packed(csr_to_packed_bcsr(csr, block_shape), csr)


def test_packed_bcsr_of_the_stencil():
    """HPCG's operator on a 12x11x10 grid in 128x128 tiles: every stored
    entry, 6 B each, in the tiles the 27-point coordinates give."""
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    csr = trandom.stencil27_csr(12, 11, 10)
    p = csr_to_packed_bcsr(csr, (128, 128))
    _check_packed(p, csr)
    assert p.nnz == csr.nnz
    assert p.val.nbytes + p.local.nbytes == 6 * csr.nnz
    row = np.repeat(np.arange(csr.rows), np.diff(csr.row_ptr.numpy()))
    tiles = np.unique(row // 128 * 11 + csr.col_ind.numpy() // 128)
    assert p.nblocks == tiles.shape[0]


def test_packed_bcsr_bf16_values():
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    csr = _edge_case_csr(130, 129, dtype=torch.bfloat16)
    p = csr_to_packed_bcsr(csr, (128, 128))
    assert p.val.dtype == torch.bfloat16
    _check_packed(p, csr)
    assert p.val.nbytes + p.local.nbytes == 4 * p.nnz


def _spoil_packed(p, case):
    """The fields of ``p`` changed so that the kernel would read out of
    bounds or into the wrong row."""
    loc, rs = p.local.long().clone(), p.row_start.long().clone()
    ptr, bc = p.tile_ptr.clone(), p.block_col.clone()
    u16 = lambda t: t.to(torch.int32).to(torch.uint16)
    if case == "entries_end_past_val":
        return dict(val=p.val[:-1], local=p.local[:-1])
    if case == "tile_ptr_shrinks":
        ptr[1] = ptr[2] + 1
        return dict(tile_ptr=ptr)
    if case == "block_col_past_the_columns":
        bc[0] = p.shape[1] // p.block_shape[1]
        return dict(block_col=bc)
    if case == "ids_out_of_order":
        loc[[0, 1]] = loc[[1, 0]]
        return dict(local=u16(loc))
    if case == "id_past_the_tile":
        loc[-1] = p.block_shape[0] * p.block_shape[1]
        return dict(local=u16(loc))
    if case == "mask_misses_a_column":
        mask = p.col_mask.clone()
        mask[0, loc[0] % p.block_shape[1] // 32] = 0
        return dict(col_mask=mask)
    # a row start that hands row 1's first entry to row 0
    t = int(torch.nonzero(rs[:, 1] > rs[:, 0])[0])
    rs[t, 1] += 1
    return dict(row_start=u16(rs))


@pytest.mark.parametrize("case", [
    "entries_end_past_val", "tile_ptr_shrinks", "block_col_past_the_columns",
    "ids_out_of_order", "id_past_the_tile", "row_start_off",
    "mask_misses_a_column"])
def test_packed_bcsr_refuses_out_of_bounds_tiles(case):
    """The kernel follows the offsets unchecked, so building a packed
    layout that would read past its entries or the operand, sum an entry
    into the wrong row or leave an operand row it reads unstaged raises on
    any device; so does a tile of more than 65,536 ids."""
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    p = csr_to_packed_bcsr(_edge_case_csr(130, 129), (64, 32))
    assert dataclasses.replace(p).nnz == p.nnz
    with pytest.raises(ValueError):
        dataclasses.replace(p, **_spoil_packed(p, case))
    with pytest.raises(ValueError):
        csr_to_packed_bcsr(_edge_case_csr(130, 129), (256, 512))
