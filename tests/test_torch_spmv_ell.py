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
from repro.kernels.spmv_ell.ref import spmv_ell_ref as jax_spmv_ell_ref
from repro.sparse import ell_from_csr, random_csr
from repro.sparse import formats as jf
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


@pytest.mark.parametrize("epilogue,with_bias", [
    (None, False), ("relu", True), ("silu", True), ("none", True),
])
def test_windowed_layout_with_perm_matches_pallas(epilogue, with_bias):
    """The marshaled call on the compacted layout: a JDS-sorted ELL whose
    rows straddle 4 windows of 128, with 61 empty rows, so that after the
    sort slab 2 is empty and slab 3 is empty and ragged (100 rows), and the
    row permutation and the bias by output row in the store; against the
    reference's windowed Pallas kernel on the sorted rows."""
    rng = np.random.default_rng(12)
    d = rng.standard_normal((100, 512)).astype(np.float32)
    d[rng.random((100, 512)) > 0.05] = 0
    d[20:81] = 0
    ell = ell_from_csr(jf.csr_from_dense(d))
    vec = rng.standard_normal(512).astype(np.float32)
    bias = rng.standard_normal(100).astype(np.float32)
    perm = np.asarray(ell.perm)
    jb = jnp.asarray(bias[perm]) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    ref = ref_ops._windowed(ell.val, ell.col, jnp.asarray(vec), 4, True,
                            window=128, epilogue=epilogue, bias=jb)
    expect = np.zeros(100, np.float32)
    expect[perm] = np.asarray(ref)[:100]
    t = tf.from_numpy(ell)
    layout = tf.ell_windows(t.val, t.col, 512, window=128, perm=t.perm)
    assert layout.n_slabs == 4 and layout.n_windows == 4
    assert torch.diff(layout.seg_ptr).tolist()[2:] == [0, 0]
    out = ell_ops._windowed(t.val, t.col, torch.from_numpy(vec), 32,
                            window=128, epilogue=epilogue, bias=tb,
                            perm=t.perm, out_rows=100, layout=layout)
    np.testing.assert_allclose(out.numpy(), expect, **TOL)


@pytest.mark.parametrize("cols", [300, 1_100_000])
def test_spmv_ell_packed_unpermutes_like_the_reference(cols):
    """Marshaled ELL: the kernel's store un-permutes the row sort and the
    fused epilogue indexes the bias by output row.  The marshaled value is
    the matrix's column-window relayout alone: at the staged body's window
    for a vector within 1<<20 elements, at K2's 65,536 beyond."""
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
    assert isinstance(packed, tf.WindowedELL)
    assert packed.window == (ell_ops.staged_window(cols, 4)
                             if cols <= 1 << 20 else tf.WINDOW)
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
    layout = tf.ell_windows(t.val, t.col, 64, window=16)
    out = K.spmv_ell_windowed_cuda(layout, v)
    torch.testing.assert_close(out, R.spmv_ell_windowed_ref(layout, v))
    out = K.spmv_ell_staged_cuda(layout, v)
    torch.testing.assert_close(out, R.spmv_ell_windowed_ref(layout, v))
    assert K.LAUNCHES == before          # the plain version is no launch
    with pytest.raises(ValueError):
        K.spmv_ell_cuda(t.val.to("meta"), t.col.to("meta"), v.to("meta"))
    meta = tf.WindowedELL(*(getattr(layout, f).to("meta") for f in (
        "val", "col", "seg_ptr", "seg_window", "seg_offset")),
        window=16, shape=layout.shape)
    with pytest.raises(ValueError):
        K.spmv_ell_windowed_cuda(meta, v.to("meta"))
    with pytest.raises(ValueError):
        K.spmv_ell_staged_cuda(meta, v.to("meta"))


@pytest.mark.parametrize("dtype,width,offset,expect", [
    (torch.float32, 384, 0, True),      # NPB-C's lane-128 ELL
    (torch.float32, 36, 0, True),
    (torch.float32, 37, 0, False),      # rows off the 16-byte step
    (torch.float32, 384, 1, False),     # data off 16-byte alignment
    (torch.bfloat16, 384, 0, True),
    (torch.bfloat16, 40, 0, True),
    (torch.bfloat16, 36, 0, False),     # 8 bf16 values a step
    (torch.bfloat16, 384, 3, False),
])
def test_direct_body_vector_path_rule(dtype, width, offset, expect):
    """Which val/col K1's direct body reads 16 bytes a lane: every row
    16-byte aligned (the CUDA wrapper passes this to the kernel)."""
    rows = 6
    val = torch.zeros(rows * width + 8, dtype=dtype)[offset:][:rows * width]
    col = torch.zeros(rows * width + 8, dtype=torch.int32)[:rows * width]
    val, col = val.view(rows, width), col.view(rows, width)
    assert val.is_contiguous() and col.data_ptr() % 16 == 0
    assert K.ell_vector_path(val, col) == expect


@pytest.mark.parametrize("width", [384, 37])
def test_padding_times_inf_is_nan_as_in_the_reference(width):
    """Padding slots (value 0, column 0) gather vec[0]: with vec[0] = inf
    their rows are NaN in the reference's sum, and in the port's plain
    version, which K1's direct body is held to on the card."""
    rng = np.random.default_rng(width)
    val = rng.standard_normal((50, width)).astype(np.float32)
    col = rng.integers(1, 300, (50, width)).astype(np.int32)
    val[::2, width // 2:] = 0
    col[::2, width // 2:] = 0
    vec = rng.standard_normal(300).astype(np.float32)
    vec[0] = np.inf
    want = np.asarray(jax_spmv_ell_ref(jnp.asarray(val), jnp.asarray(col),
                                       jnp.asarray(vec)))
    got = K.spmv_ell_cuda(torch.from_numpy(val), torch.from_numpy(col),
                          torch.from_numpy(vec)).numpy()
    assert np.isnan(want[::2]).all() and np.isfinite(want[1::2]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cols,size,expect", [
    (150_000, 4, 50_000),       # NAS CG class C, f32: 3 windows of 200 KB
    (1 << 20, 4, 55_192),       # RESIDENT_VEC_LIMIT: 19 windows
    (150_000, 2, 50_000),       # bf16: 16-bit ids cap the window at 65,536
    (100_000, 2, 50_000),
    (300, 4, 304),              # one window, rounded up to 8
])
def test_staged_window_fits_shared_memory(cols, size, expect):
    w = ell_ops.staged_window(cols, size)
    assert w == expect and w % 8 == 0
    assert w * size <= K.STAGE_BYTES and w <= 1 << 16
    assert -(-cols // w) == -(-cols // (min(1 << 16, K.STAGE_BYTES // size)
                                        // 8 * 8))


@pytest.mark.parametrize("epilogue,with_bias", [
    (None, False), ("relu", True), ("silu", True), ("none", True),
    ("silu", False),
])
@pytest.mark.parametrize("window", [64, 136, 512])
def test_staged_layout_matches_pallas(epilogue, with_bias, window):
    """K1's marshaled call on a small window, so that a 100 x 512 matrix
    spans 8, 4 or 1 windows: a JDS-sorted ELL with 61 empty rows (after the
    sort slab 2 is empty and slab 3 empty and ragged), the row permutation
    and the bias by output row in the store; against the resident Pallas
    kernel (spmv_ell_pallas) on the sorted rows."""
    rng = np.random.default_rng(13)
    d = rng.standard_normal((100, 512)).astype(np.float32)
    d[rng.random((100, 512)) > 0.08] = 0
    d[20:81] = 0
    ell = ell_from_csr(jf.csr_from_dense(d))
    vec = rng.standard_normal(512).astype(np.float32)
    bias = rng.standard_normal(100).astype(np.float32)
    perm = np.asarray(ell.perm)
    jb = jnp.asarray(bias[perm]) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    ref = ref_ops.spmv_ell(ell.val, ell.col, jnp.asarray(vec),
                           epilogue=epilogue, bias=jb, interpret=True)
    expect = np.zeros(100, np.float32)
    expect[perm] = np.asarray(ref)[:100]
    t = tf.from_numpy(ell)
    layout = tf.ell_windows(t.val, t.col, 512, window=window, perm=t.perm)
    assert layout.n_windows == -(-512 // window) and layout.n_slabs == 4
    assert torch.diff(layout.seg_ptr).tolist()[2:] == [0, 0]
    out = K.spmv_ell_staged_cuda(layout, torch.from_numpy(vec), bias=tb,
                                 perm=t.perm, out_rows=100, epilogue=epilogue)
    np.testing.assert_allclose(out.numpy(), expect, **TOL)
