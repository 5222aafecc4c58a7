"""Wrappers of the hand-written CUDA ELL SpMV kernels (``csrc/spmv_ell.cu``).

Counterpart of ``repro.kernels.spmv_ell.kernel``:

  spmv_ell_cuda           <- spmv_ell_pallas           (K1, resident vector)
  spmv_ell_windowed_cuda  <- spmv_ell_windowed_pallas  (K2, column windows)

Both take an optional row permutation (the kernel stores row i at
``perm[i]``) and the fused ``(+bias) -> relu|silu`` epilogue (K5).  For
tensors on the CPU a wrapper returns its kernel's plain version
(``ref.py``); for CUDA tensors it launches the kernel on the current stream
or raises.  ``LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import EPILOGUE_CODES
from repro_torch.kernels.spmv_ell.ref import (spmv_ell_plain,
                                              spmv_ell_windowed_plain)

SOURCE = Path(__file__).parent / "csrc" / "spmv_ell.cu"

#: kernel name -> launches since the last reset (a plain count).
LAUNCHES = {"spmv_ell": 0, "spmv_ell_windowed": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_FNS: Dict[str, Callable] = {}


def _fn(name: str):
    """The C entry point ``name``, building and loading the library on
    first use (later calls cost one dict lookup)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(SOURCE), name)
        n_ints = 4 if "windowed" not in name else 6
        fn.argtypes = [_P] * 6 + [_I] * n_ints + [_P]
        fn.restype = _I
        _FNS[name] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name, t, device, dtype, shape=None):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(val, col, vec, bias, perm, out_rows, epilogue, rows_per_slab):
    """Check the operands of either kernel; allocate the output."""
    dev = val.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if val.dtype not in _SUFFIX:
        raise TypeError(f"val must be float32 or bfloat16, got {val.dtype}")
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if rows_per_slab <= 0:
        raise ValueError(f"rows_per_slab must be positive, got {rows_per_slab}")
    rows = val.shape[0]
    _check("val", val, dev, val.dtype)
    _check("col", col, dev, torch.int32, val.shape)
    _check("vec", vec, dev, val.dtype)
    if vec.dim() != 1:
        raise ValueError("vec must be 1-D")
    if perm is None:
        out_rows = rows
        out = torch.empty(rows, dtype=torch.float32, device=dev)
    else:
        _check("perm", perm, dev, torch.int32, (rows,))
        out_rows = rows if out_rows is None else out_rows
        # rows no perm entry names must read 0
        out = torch.zeros(out_rows, dtype=torch.float32, device=dev)
    if bias is not None:
        _check("bias", bias, dev, torch.float32, (out_rows,))
    return out


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


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
    out = _prepare(val, col, vec, bias, perm, out_rows, epilogue,
                   rows_per_slab)
    rows, width = val.shape
    if rows == 0:
        return out
    with torch.cuda.device(val.device):
        err = _fn(f"spmv_ell_{_SUFFIX[val.dtype]}")(
            val.data_ptr(), col.data_ptr(), vec.data_ptr(), _ptr(bias),
            _ptr(perm), out.data_ptr(), rows, width, rows_per_slab,
            EPILOGUE_CODES[epilogue], torch.cuda.current_stream().cuda_stream)
    _launched("spmv_ell", err)
    return out


def spmv_ell_windowed_cuda(val: torch.Tensor, col: torch.Tensor,
                           vec: torch.Tensor, *, window: int,
                           bias: Optional[torch.Tensor] = None,
                           perm: Optional[torch.Tensor] = None,
                           out_rows: Optional[int] = None,
                           epilogue: Optional[str] = None,
                           rows_per_slab: int = 32) -> torch.Tensor:
    """K2: the same sum over val/col ``(rows, n_windows, width)`` whose
    column ids are local to window w, which starts at ``vec[w*window]``."""
    if val.device.type == "cpu":
        return spmv_ell_windowed_plain(val, col, vec, window=window,
                                       bias=bias, perm=perm,
                                       out_rows=out_rows, epilogue=epilogue)
    if val.dim() != 3:
        raise ValueError("val must be (rows, n_windows, width), got "
                         f"{tuple(val.shape)}")
    out = _prepare(val, col, vec, bias, perm, out_rows, epilogue,
                   rows_per_slab)
    rows, n_windows, width = val.shape
    if vec.shape[0] <= (n_windows - 1) * window:
        raise ValueError(f"vec of {vec.shape[0]} elements has no window "
                         f"{n_windows - 1} of {window}")
    if rows == 0:
        return out
    with torch.cuda.device(val.device):
        err = _fn(f"spmv_ell_windowed_{_SUFFIX[val.dtype]}")(
            val.data_ptr(), col.data_ptr(), vec.data_ptr(), _ptr(bias),
            _ptr(perm), out.data_ptr(), rows, n_windows, width, window,
            rows_per_slab, EPILOGUE_CODES[epilogue],
            torch.cuda.current_stream().cuda_stream)
    _launched("spmv_ell_windowed", err)
    return out
