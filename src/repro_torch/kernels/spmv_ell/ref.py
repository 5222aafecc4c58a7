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
from repro_torch.sparse.formats import SLAB, WindowedELL


def spmv_ell_ref(val: torch.Tensor, col: torch.Tensor,
                 vec: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j val[i, j] * vec[col[i, j]]  (padding: val==0)."""
    return torch.sum(val.float() * vec.float()[col.long()], dim=1)


def spmv_ell_windowed_ref(layout: WindowedELL,
                          vec: torch.Tensor) -> torch.Tensor:
    """The same sum over the slab-compacted column-window layout: slot p of
    segment s belongs to row ``SLAB * slab(s) + (p - seg_offset[s]) % SLAB``
    and gathers ``vec[seg_window[s] * window + col[p]]``."""
    dev = layout.val.device
    n_slots = layout.val.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(layout.n_segments, device=dev),
        torch.diff(layout.seg_offset), output_size=n_slots)
    slab = torch.repeat_interleave(
        torch.arange(layout.n_slabs, device=dev),
        torch.diff(layout.seg_ptr).long(), output_size=layout.n_segments)
    slot = torch.arange(n_slots, device=dev) - layout.seg_offset[seg]
    row = slab[seg] * SLAB + slot % SLAB
    gcol = layout.seg_window[seg].long() * layout.window + layout.col.long()
    acc = torch.zeros(layout.n_slabs * SLAB, dtype=torch.float32, device=dev)
    acc.index_add_(0, row, layout.val.float() * vec.float()[gcol])
    return acc[:layout.shape[0]]


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


def spmv_ell_windowed_plain(layout: WindowedELL, vec, *, bias=None,
                            perm=None, out_rows: Optional[int] = None,
                            epilogue: Optional[str] = None) -> torch.Tensor:
    """What the windowed kernel (K2) computes."""
    return _store(spmv_ell_windowed_ref(layout, vec), bias, perm, out_rows,
                  epilogue)
