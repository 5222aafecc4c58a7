"""Plain torch versions of the ELL SpMV kernels.

``spmv_ell_ref`` is the counterpart of ``repro.kernels.spmv_ell.ref``.
``spmv_ell_plain`` and ``spmv_ell_windowed_plain`` compute exactly what
the two CUDA kernels compute, row permutation and epilogue included: the
wrappers in ``kernel.py`` run them for CPU tensors, and the kernels are
held against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import apply_epilogue_inregister


def spmv_ell_ref(val: torch.Tensor, col: torch.Tensor,
                 vec: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j val[i, j] * vec[col[i, j]]  (padding: val==0)."""
    return torch.sum(val.float() * vec.float()[col.long()], dim=1)


def spmv_ell_windowed_ref(val: torch.Tensor, col: torch.Tensor,
                          vec: torch.Tensor, window: int) -> torch.Tensor:
    """The same sum over a (rows, n_windows, width) layout whose column ids
    are local to their window."""
    n_windows = val.shape[1]
    v = vec.float()
    if v.shape[0] < n_windows * window:
        v = torch.nn.functional.pad(v, (0, n_windows * window - v.shape[0]))
    base = torch.arange(n_windows, device=val.device)[None, :, None] * window
    return torch.sum(val.float() * v[base + col.long()], dim=(1, 2))


def _store(acc: torch.Tensor, bias, perm, out_rows: Optional[int],
           epilogue: Optional[str]) -> torch.Tensor:
    """The kernels' store: out[perm[i]] = epilogue(acc[i] + bias[perm[i]]),
    rows that no perm entry names stay 0."""
    if perm is None:
        return apply_epilogue_inregister(acc, bias, epilogue)
    rows = acc.shape[0] if out_rows is None else out_rows
    p = perm.long()
    out = torch.zeros(rows, dtype=torch.float32, device=acc.device)
    b = None if bias is None else bias[p]
    out[p] = apply_epilogue_inregister(acc, b, epilogue)
    return out


def spmv_ell_plain(val, col, vec, *, bias=None, perm=None,
                   out_rows: Optional[int] = None,
                   epilogue: Optional[str] = None) -> torch.Tensor:
    """What the resident kernel (K1) computes."""
    return _store(spmv_ell_ref(val, col, vec), bias, perm, out_rows, epilogue)


def spmv_ell_windowed_plain(val, col, vec, *, window: int, bias=None,
                            perm=None, out_rows: Optional[int] = None,
                            epilogue: Optional[str] = None) -> torch.Tensor:
    """What the windowed kernel (K2) computes."""
    return _store(spmv_ell_windowed_ref(val, col, vec, window), bias, perm,
                  out_rows, epilogue)
