"""Shape normalisation and variant choice for the ELL SpMV kernels.

Counterpart of ``repro.kernels.spmv_ell.ops``: the slab geometry (row
padding and the clamp for tiny row counts), the resident / column-windowed
split at ``RESIDENT_VEC_LIMIT``, the slab-compacted column-window layout,
and the unfused fallback for a bias that is not 1-D.

The split decides two things.  A user's ELL/JDS arrays (``spmv_ell``)
take K1's direct body within the limit and K2 beyond it.  A marshaled CSR
(``pack_ell128`` / ``spmv_ell_packed``) is kept only as the slab-compacted
column-window layout: within the limit at a window that fits shared memory
(``staged_window``), run by K1's staged body; beyond it at 65,536 columns,
run by K2.  The kernels mask the ragged last slab themselves, so row
padding sets the launch grid and copies nothing.

``lilac_torch::spmv_ell`` is ``spmv_ell`` as a ``torch.library`` custom op
(with a fake kernel that gives its output's shape and dtype), the form in
which the direct ELL/JDS harness appears in a trace-mode graph: it does
not mutate its inputs and needs no host sync, so ``make_fx``,
``torch.compile`` and CUDA-graph capture pass through it.  Its autograd
formula is the ``vjp`` clause's body (``harness.BUILTIN_VJPS
["spmv_ell_bwd"]``) behind the derivative of a fused epilogue, recomputed
from the pre-activation (the rewriter unfuses the epilogue under
differentiation, so a rewritten graph reaches it only without one).
``lilac_torch::spmv_ell_layout`` is the marshaled path's launch
(``spmv_ell_packed``) as a custom op on the layout's tensors, taken for a
vector of a ``torch.func`` transform.  Both take
a batch of vectors ``(B, cols)`` as one launch, and both carry a
``register_vmap`` rule (``common.vmap_over_vectors``): under
``torch.func.vmap`` a batched vector is one launch of the batch, a batched
matrix one launch an element.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import (apply_epilogue_inregister,
                                        differentiable, epilogue_cotangent,
                                        vmap_over_vectors)
from repro_torch.kernels.spmv_ell.ref import (acc_dtype,
                                              spmv_ell_windowed_plain)
from repro_torch.kernels.spmv_ell.kernel import (STAGE_BYTES, spmv_ell_cuda,
                                                 spmv_ell_staged_cuda,
                                                 spmv_ell_windowed_cuda)
from repro_torch.sparse.convert import csr_to_ell
from repro_torch.sparse.formats import (CSR, SEG_WIDTH, WINDOW,
                                        WindowedELL, ell_windows, rebuilt)

# Vector sizes above this use the column-windowed kernel.
RESIDENT_VEC_LIMIT = 1 << 20  # 1M elements (4 MiB f32)
# Rows a thread block covers (the reference's default slab).
ROWS_PER_SLAB = 32


def slab_geometry(rows: int, rows_per_slab: int) -> Tuple[int, int]:
    """(rows per slab, padded rows): rows pad to a whole number of slabs,
    and a matrix with fewer rows than a slab gets the largest power-of-two
    slab (at least 8) that its rows fill."""
    pad = (-rows) % rows_per_slab
    if 0 < rows < rows_per_slab:
        rows_per_slab = max(8, 1 << int(math.floor(math.log2(rows))))
        pad = (-rows) % rows_per_slab
    return rows_per_slab, rows + pad


def _fusable(bias, out_rows: int) -> bool:
    return bias is None or (isinstance(bias, torch.Tensor) and bias.dim() == 1
                            and bias.shape[0] == out_rows)


def spmv_ell(val: torch.Tensor, col: torch.Tensor, vec: torch.Tensor,
             rows_per_slab: int = ROWS_PER_SLAB,
             epilogue: Optional[str] = None,
             bias=None,
             perm: Optional[torch.Tensor] = None,
             out_rows: Optional[int] = None) -> torch.Tensor:
    """ELL SpMV: ``out[o(i)] = epilogue(sum_j val[i,j]*vec[col[i,j]] +
    bias)``, ``o = perm`` or the identity.  A bias the kernels cannot index
    per output row (scalar, broadcast-shaped) applies after the kernel:
    still right, just unfused.  ``vec`` may be a batch ``(B, cols)``: one
    launch, ``(B, out rows)`` out."""
    rows = val.shape[0]
    n_out = rows if perm is None or out_rows is None else out_rows
    if bias is not None and not _fusable(bias, n_out):
        out = spmv_ell(val, col, vec, rows_per_slab=rows_per_slab, perm=perm,
                       out_rows=out_rows)
        return apply_epilogue_inregister(out, bias, epilogue)
    if bias is not None:
        bias = bias.to(acc_dtype(val.dtype)).contiguous()
    if vec.shape[-1] <= RESIDENT_VEC_LIMIT:
        rows_per_slab, _ = slab_geometry(rows, rows_per_slab)
        return spmv_ell_cuda(val, col, vec, bias=bias, perm=perm,
                             out_rows=out_rows, epilogue=epilogue,
                             rows_per_slab=rows_per_slab)
    return _windowed(val, col, vec, rows_per_slab, epilogue=epilogue,
                     bias=bias, perm=perm, out_rows=out_rows)


@torch.library.custom_op("lilac_torch::spmv_ell", mutates_args=())
def spmv_ell_op(val: torch.Tensor, col: torch.Tensor, vec: torch.Tensor,
                bias: Optional[torch.Tensor], perm: Optional[torch.Tensor],
                out_rows: Optional[int], epilogue: Optional[str],
                rows_per_slab: int) -> torch.Tensor:
    """:func:`spmv_ell` as a custom op: f32 out of ``(rows,)``, or
    ``(out_rows,)`` with a ``perm``, behind a leading batch axis for a
    batch of vectors ``(B, cols)``; a ``bias`` must be a 1-D tensor of that
    length (the fused one)."""
    n_out = _out_rows(val, perm, out_rows)
    if not _fusable(bias, n_out):
        raise ValueError(f"bias must be 1-D of {n_out} rows")
    return spmv_ell(val, col, vec, rows_per_slab=rows_per_slab,
                    epilogue=epilogue, bias=bias, perm=perm,
                    out_rows=out_rows)


@spmv_ell_op.register_fake
def _spmv_ell_fake(val, col, vec, bias, perm, out_rows, epilogue,
                   rows_per_slab):
    return val.new_empty(tuple(vec.shape[:-1])
                         + (_out_rows(val, perm, out_rows),),
                         dtype=acc_dtype(val.dtype))


def _spmv_ell_setup(ctx, inputs, output):
    val, col, vec, bias, perm, out_rows, epilogue, rows_per_slab = inputs
    ctx.save_for_backward(val, col, vec, bias, perm)
    ctx.args = (out_rows, epilogue, rows_per_slab)


def _spmv_ell_backward(ctx, ct):
    from repro_torch.core.harness import BUILTIN_VJPS

    val, col, vec, bias, perm = ctx.saved_tensors
    out_rows, epilogue, rows_per_slab = ctx.args
    dz = ct
    if epilogue in ("relu", "silu"):
        with torch.no_grad():       # the pre-activation, a constant here
            z = spmv_ell_op(val, col, vec, bias, perm, out_rows, None,
                            rows_per_slab)
        dz = epilogue_cotangent(z, ct, epilogue)
    b = {"val": val, "col_ind": col, "vector": vec,
         "perm": None if perm is None else perm.long()}
    body = BUILTIN_VJPS["spmv_ell_bwd"]
    if vec.dim() == 1:
        g = body(b, None, None, dz)
        dval = g["val"]
    else:
        # a batch of vectors: each its own cotangent, the matrix's summed
        g = torch.func.vmap(lambda v, c: body(dict(b, vector=v), None, None,
                                              c))(vec, dz)
        dval = g["val"].sum(0)
        dz = dz.sum(0)
    dbias = None
    if bias is not None and ctx.needs_input_grad[3]:
        dbias = _bias_cotangent(dz, perm).to(bias.dtype)
    return (dval.to(val.dtype), None, g["vector"].to(vec.dtype), dbias,
            None, None, None, None)


def _bias_cotangent(dz, perm):
    """A per-row bias's cotangent: a row that no perm entry names is
    stored as 0, bias or not."""
    return dz if perm is None else torch.zeros_like(dz).index_copy(
        0, perm.long(), dz[perm.long()])


spmv_ell_op.register_autograd(_spmv_ell_backward,
                              setup_context=_spmv_ell_setup)


def _spmv_ell_batch(fn, info, in_dims, *args):
    return vmap_over_vectors(fn, info, in_dims, args, pos=2)


spmv_ell_op.register_vmap(functools.partial(_spmv_ell_batch, spmv_ell_op))
#: ``spmv_ell_op`` differentiable under every transform
spmv_ell_call = differentiable(spmv_ell_op, _spmv_ell_setup,
                               _spmv_ell_backward, _spmv_ell_batch)


def _out_rows(val, perm, out_rows: Optional[int]) -> int:
    return val.shape[0] if perm is None or out_rows is None else out_rows


def _windowed(val, col, vec, rows_per_slab, window: int = WINDOW,
              epilogue: Optional[str] = None, bias=None, perm=None,
              out_rows: Optional[int] = None,
              layout: Optional[WindowedELL] = None):
    """Compact the slots by slab and column window (unless ``layout``
    already holds them) and run the windowed kernel.  ``rows_per_slab`` is
    the reference's argument and sets nothing here: the layout's slab is a
    warp's 32 rows (``formats.SLAB``), and the kernel masks a ragged
    last slab itself."""
    if layout is None:
        layout = ell_windows(val, col, vec.shape[-1], window)
    return spmv_ell_windowed_cuda(layout, vec, bias=bias, perm=perm,
                                  out_rows=out_rows, epilogue=epilogue)


def staged_window(cols: int, element_size: int) -> int:
    """The column window of K1's staged body: the vector's columns in as
    few windows as fit ``STAGE_BYTES`` of shared memory (and 16-bit local
    ids), split evenly and rounded up to ``SEG_WIDTH`` so that each window
    starts on a 16-byte boundary (50,000 for NAS CG class C's 150,000 f32
    columns)."""
    most = min(WINDOW, STAGE_BYTES // element_size) // SEG_WIDTH * SEG_WIDTH
    n_windows = max(1, -(-cols // most))
    return -(-max(1, -(-cols // n_windows)) // SEG_WIDTH) * SEG_WIDTH


def pack_ell128(csr: CSR) -> WindowedELL:
    """The marshaled form of a CSR matrix that the kernels read: the
    slab-compacted column-window layout of its lane-128 ELL (the JDS row
    sort kept as ``perm``), at ``staged_window`` for a vector within
    ``RESIDENT_VEC_LIMIT`` and at 65,536 columns beyond it.  Neither
    kernel reads the ELL or its padding, so they are not kept."""
    ell = csr_to_ell(csr, lane=128)
    window = staged_window(csr.cols, ell.val.element_size()) \
        if csr.cols <= RESIDENT_VEC_LIMIT else WINDOW
    return ell_windows(ell.val, ell.col, csr.cols, window=window,
                       perm=ell.perm)


def spmv_ell_packed(packed: WindowedELL, vec: torch.Tensor,
                    epilogue: Optional[str] = None,
                    bias=None) -> torch.Tensor:
    """SpMV with a :func:`pack_ell128` value: K1's staged body within
    ``RESIDENT_VEC_LIMIT`` columns, K2 beyond; the kernel un-permutes the
    JDS row sort in its store.  A vector of a ``torch.func`` transform
    goes through the custom op ``lilac_torch::spmv_ell_layout``, so that
    under ``torch.func.vmap`` a batch is one launch; a plain one calls the
    wrapper directly, sparing the host the op's dispatch."""
    rows = packed.shape[0]
    if bias is not None and not _fusable(bias, rows):
        out = spmv_ell_packed(packed, vec)
        return apply_epilogue_inregister(out, bias, epilogue)
    if bias is not None:
        bias = bias.float().contiguous()
    if not torch._C._functorch.is_functorch_wrapped_tensor(vec):
        return _packed_launch(packed, vec, bias, epilogue)
    return spmv_ell_layout_op(packed.val, packed.col, packed.seg_ptr,
                              packed.seg_window, packed.seg_offset,
                              packed.perm, vec, bias, packed.window, rows,
                              packed.shape[1], epilogue)


def _packed_launch(layout: WindowedELL, vec, bias, epilogue):
    run = spmv_ell_staged_cuda if layout.shape[1] <= RESIDENT_VEC_LIMIT \
        else spmv_ell_windowed_cuda
    return run(layout, vec, bias=bias, perm=layout.perm,
               out_rows=layout.shape[0], epilogue=epilogue)


@torch.library.custom_op("lilac_torch::spmv_ell_layout", mutates_args=())
def spmv_ell_layout_op(val: torch.Tensor, col: torch.Tensor,
                       seg_ptr: torch.Tensor, seg_window: torch.Tensor,
                       seg_offset: torch.Tensor, perm: Optional[torch.Tensor],
                       vec: torch.Tensor, bias: Optional[torch.Tensor],
                       window: int, rows: int, cols: int,
                       epilogue: Optional[str]) -> torch.Tensor:
    """The staged or windowed launch on a :func:`pack_ell128` layout given
    by its tensors (the layout was checked when it was built), f32 out of
    ``(rows,)`` behind a leading batch axis for a batch of vectors ``(B,
    cols)``.  Its vmap rule runs a batched vector as one launch and a
    batched layout or bias as one launch an element.  Its autograd formula
    differentiates the vector and the bias (Aᵀ·ct through the layout's
    plain version); the layout is a marshaled buffer, and a harness that
    differentiates the matrix's own values does so in its ``vjp``
    clause's Function."""
    layout = rebuilt(WindowedELL, val=val, col=col, seg_ptr=seg_ptr,
                     seg_window=seg_window, seg_offset=seg_offset,
                     window=window, shape=(rows, cols), perm=perm)
    return _packed_launch(layout, vec, bias, epilogue)


@spmv_ell_layout_op.register_fake
def _spmv_ell_layout_fake(val, col, seg_ptr, seg_window, seg_offset, perm,
                          vec, bias, window, rows, cols, epilogue):
    return vec.new_empty(tuple(vec.shape[:-1]) + (rows,),
                         dtype=torch.float32)


def _spmv_ell_layout_batch(fn, info, in_dims, *args):
    return vmap_over_vectors(fn, info, in_dims, args, pos=6)


spmv_ell_layout_op.register_vmap(
    functools.partial(_spmv_ell_layout_batch, spmv_ell_layout_op))


def _spmv_ell_layout_setup(ctx, inputs, output):
    (val, col, seg_ptr, seg_window, seg_offset, perm, vec, bias, window,
     rows, cols, epilogue) = inputs
    ctx.save_for_backward(val, col, seg_ptr, seg_window, seg_offset, perm,
                          vec, bias)
    ctx.args = (window, rows, cols, epilogue)


def _spmv_ell_layout_backward(ctx, ct):
    val, col, seg_ptr, seg_window, seg_offset, perm, vec, bias = \
        ctx.saved_tensors
    window, rows, cols, epilogue = ctx.args
    if ctx.needs_input_grad[0]:
        raise NotImplementedError(
            "lilac_torch::spmv_ell_layout differentiates its vector and "
            "bias, not the marshaled layout's values")
    dz = ct
    if epilogue in ("relu", "silu"):
        with torch.no_grad():
            z = spmv_ell_layout_op(val, col, seg_ptr, seg_window,
                                   seg_offset, perm, vec, bias, window, rows,
                                   cols, None)
        dz = epilogue_cotangent(z, ct, epilogue)
    layout = rebuilt(WindowedELL, val=val, col=col, seg_ptr=seg_ptr,
                     seg_window=seg_window, seg_offset=seg_offset,
                     window=window, shape=(rows, cols), perm=perm)
    def linear(v):
        return spmv_ell_windowed_plain(layout, v, perm=perm, out_rows=rows)

    if vec.dim() > 1:                   # a batch of vectors (B, cols)
        linear = torch.func.vmap(linear)
    _, pull = torch.func.vjp(linear, vec)
    (dvec,) = pull(dz.to(torch.float32))
    dbias = None
    if bias is not None and ctx.needs_input_grad[7]:
        dbias = _bias_cotangent(dz.reshape(-1, rows).sum(0), perm)
        dbias = dbias.to(bias.dtype)
    return (None, None, None, None, None, None, dvec.to(vec.dtype), dbias,
            None, None, None, None)


spmv_ell_layout_op.register_autograd(_spmv_ell_layout_backward,
                                     setup_context=_spmv_ell_layout_setup)
#: ``spmv_ell_layout_op`` differentiable under every transform
spmv_ell_layout_call = differentiable(
    spmv_ell_layout_op, _spmv_ell_layout_setup, _spmv_ell_layout_backward,
    _spmv_ell_layout_batch)
