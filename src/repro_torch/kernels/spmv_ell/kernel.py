"""Wrappers of the hand-written CUDA ELL SpMV kernels (``csrc/spmv_ell.cu``).

Counterpart of ``repro.kernels.spmv_ell.kernel``:

  spmv_ell_staged_cuda    <- spmv_ell_pallas           (K1 on the marshaled
                                                       path: the vector
                                                       staged in shared
                                                       memory, window by
                                                       window)
  spmv_ell_cuda           <- spmv_ell_pallas           (K1 on a user's
                                                       ELL/JDS arrays)
  spmv_ell_windowed_cuda  <- spmv_ell_windowed_pallas  (K2, column windows,
                                                       slab-compacted)

The staged and windowed bodies read the same layout
(``formats.WindowedELL``): the staged one at a window that fits shared
memory (``STAGE_BYTES``), K2 at 65,536 columns read from L2.  Each takes
an optional row permutation (the kernel stores row i at ``perm[i]``) and
the fused ``(+bias) -> relu|silu`` epilogue (K5).  For tensors on the CPU
a wrapper returns its kernel's plain version (``ref.py``); for CUDA
tensors it launches the kernel on the current stream or raises.
``LAUNCHES`` counts the launches of each body.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (EPILOGUE_CODES, check_tensor,
                                        counter, launched)
from repro_torch.kernels.spmv_ell.ref import (spmv_ell_plain,
                                              spmv_ell_windowed_plain)
from repro_torch.sparse.formats import WindowedELL

SOURCE = Path(__file__).parent / "csrc" / "spmv_ell.cu"

#: kernel name -> launches since the last reset (a plain count; an
#: executable plan's CUDA-graph replay adds the launches it replays).
LAUNCHES = counter(("spmv_ell", "spmv_ell_staged", "spmv_ell_windowed"))

#: Shared memory the staged body may fill with a window of the vector (of
#: the 227 KB a block can have on an H100).
STAGE_BYTES = 224 * 1024

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str):
    if "windowed" in name:
        return build.entry_point(SOURCE, name, 9, 4)
    if "staged" in name:
        return build.entry_point(SOURCE, name, 9, 5)
    return build.entry_point(SOURCE, name, 6, 4)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _prepare(val, vec, bias, perm, rows, out_rows, epilogue):
    """Check the operands both kernels share; allocate the output."""
    dev = val.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if val.dtype not in _SUFFIX:
        raise TypeError(f"val must be float32 or bfloat16, got {val.dtype}")
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    check_tensor("val", val, dev, val.dtype)
    check_tensor("vec", vec, dev, val.dtype)
    if vec.dim() != 1:
        raise ValueError("vec must be 1-D")
    if perm is None:
        out_rows = rows
        out = torch.empty(rows, dtype=torch.float32, device=dev)
    else:
        check_tensor("perm", perm, dev, torch.int32, (rows,))
        out_rows = rows if out_rows is None else out_rows
        # rows no perm entry names must read 0
        out = torch.zeros(out_rows, dtype=torch.float32, device=dev)
    if bias is not None:
        check_tensor("bias", bias, dev, torch.float32, (out_rows,))
    return out


def spmv_ell_cuda(val: torch.Tensor, col: torch.Tensor, vec: torch.Tensor, *,
                  bias: Optional[torch.Tensor] = None,
                  perm: Optional[torch.Tensor] = None,
                  out_rows: Optional[int] = None,
                  epilogue: Optional[str] = None,
                  rows_per_slab: int = 32) -> torch.Tensor:
    """K1: ``out[o(i)] = epilogue(sum_j val[i,j]*vec[col[i,j]] + bias[o(i)])``
    with ``o = perm`` or the identity; val/col ``(rows, width)``, f32 out."""
    if val.device.type == "cpu":
        return spmv_ell_plain(val, col, vec, bias=bias, perm=perm,
                              out_rows=out_rows, epilogue=epilogue)
    if val.dim() != 2:
        raise ValueError(f"val must be (rows, width), got {tuple(val.shape)}")
    if rows_per_slab <= 0:
        raise ValueError(f"rows_per_slab must be positive, got {rows_per_slab}")
    rows, width = val.shape
    out = _prepare(val, vec, bias, perm, rows, out_rows, epilogue)
    check_tensor("col", col, val.device, torch.int32, val.shape)
    if rows == 0:
        return out
    with torch.cuda.device(val.device):
        err = _fn(f"spmv_ell_{_SUFFIX[val.dtype]}")(
            val.data_ptr(), col.data_ptr(), vec.data_ptr(), _ptr(bias),
            _ptr(perm), out.data_ptr(), rows, width, rows_per_slab,
            EPILOGUE_CODES[epilogue], torch.cuda.current_stream().cuda_stream)
    launched(LAUNCHES, "spmv_ell", err)
    return out


def _check_layout(layout: WindowedELL, vec: torch.Tensor) -> None:
    dev = layout.val.device
    n_slabs, n_seg = layout.n_slabs, layout.n_segments
    check_tensor("col", layout.col, dev, torch.uint16, layout.val.shape)
    check_tensor("seg_ptr", layout.seg_ptr, dev, torch.int32, (n_slabs + 1,))
    check_tensor("seg_window", layout.seg_window, dev, torch.int32, (n_seg,))
    check_tensor("seg_offset", layout.seg_offset, dev, torch.int64,
                 (n_seg + 1,))
    if vec.shape[0] < layout.shape[1]:
        raise ValueError(f"vec of {vec.shape[0]} elements does not cover "
                         f"the layout's {layout.shape[1]} columns")


def _layout_ptrs(layout: WindowedELL):
    return (layout.val.data_ptr(), layout.col.data_ptr(),
            layout.seg_ptr.data_ptr(), layout.seg_window.data_ptr(),
            layout.seg_offset.data_ptr())


def spmv_ell_staged_cuda(layout: WindowedELL, vec: torch.Tensor, *,
                         bias: Optional[torch.Tensor] = None,
                         perm: Optional[torch.Tensor] = None,
                         out_rows: Optional[int] = None,
                         epilogue: Optional[str] = None) -> torch.Tensor:
    """K1 on the marshaled path: the sum of :func:`spmv_ell_windowed_cuda`
    over a layout whose window of ``vec`` fits ``STAGE_BYTES`` of shared
    memory; each CTA stages the vector window by window."""
    val = layout.val
    if val.device.type == "cpu":
        return spmv_ell_windowed_plain(layout, vec, bias=bias, perm=perm,
                                       out_rows=out_rows, epilogue=epilogue)
    rows, cols = layout.shape
    out = _prepare(val, vec, bias, perm, rows, out_rows, epilogue)
    _check_layout(layout, vec)
    if layout.window * val.element_size() > STAGE_BYTES:
        raise ValueError(f"a window of {layout.window} {val.dtype} columns "
                         f"exceeds the {STAGE_BYTES} B the staged body "
                         f"stages; build the layout with staged_window()")
    if rows == 0:
        return out
    with torch.cuda.device(val.device):
        err = _fn(f"spmv_ell_staged_{_SUFFIX[val.dtype]}")(
            *_layout_ptrs(layout), vec.data_ptr(), _ptr(bias), _ptr(perm),
            out.data_ptr(), rows, cols, layout.n_slabs, layout.window,
            EPILOGUE_CODES[epilogue], torch.cuda.current_stream().cuda_stream)
    launched(LAUNCHES, "spmv_ell_staged", err)
    return out


def spmv_ell_windowed_cuda(layout: WindowedELL, vec: torch.Tensor, *,
                           bias: Optional[torch.Tensor] = None,
                           perm: Optional[torch.Tensor] = None,
                           out_rows: Optional[int] = None,
                           epilogue: Optional[str] = None) -> torch.Tensor:
    """K2: the same sum over the slab-compacted column-window layout of
    ``formats.ell_windows``; ``vec`` covers the layout's columns.  The
    layout bounded its segments when it was built (``WindowedELL``)."""
    val = layout.val
    if val.device.type == "cpu":
        return spmv_ell_windowed_plain(layout, vec, bias=bias, perm=perm,
                                       out_rows=out_rows, epilogue=epilogue)
    rows = layout.shape[0]
    out = _prepare(val, vec, bias, perm, rows, out_rows, epilogue)
    _check_layout(layout, vec)
    if rows == 0:
        return out
    with torch.cuda.device(val.device):
        err = _fn(f"spmv_ell_windowed_{_SUFFIX[val.dtype]}")(
            *_layout_ptrs(layout), vec.data_ptr(), _ptr(bias), _ptr(perm),
            out.data_ptr(), rows, layout.n_slabs, layout.window,
            EPILOGUE_CODES[epilogue], torch.cuda.current_stream().cuda_stream)
    launched(LAUNCHES, "spmv_ell_windowed", err)
    return out
