"""Wrapper of the hand-written CUDA grouped-matmul kernel (``csrc/moe_gmm.cu``).

Counterpart of ``repro.kernels.moe_gmm.kernel``:

  gmm_cuda  <- gmm_pallas  (K4)

For tensors on the CPU the wrapper returns the kernel's plain version
(``ref.gmm_ref``); for CUDA tensors it launches the kernel on the current
stream or raises.  ``LAUNCHES`` counts the launches of each body: ``gmm``
the bf16 body (``gmm_tc_kernel``), ``gmm_f32`` the f32 one
(``gmm_simt_kernel``).
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, counter, launched
from repro_torch.kernels.moe_gmm.ref import gmm_ref

SOURCE = Path(__file__).parent / "csrc" / "moe_gmm.cu"

#: kernel name -> launches since the last reset (a plain count; an
#: executable plan's CUDA-graph replay adds the launches it replays).
LAUNCHES = counter(("gmm", "gmm_f32"))

#: Rows a CTA covers at most (tm is at most this or a multiple of it).
MAX_TILE = 128

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def f32_vector_path(xs: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether f32 operands take the f32 body's 16-byte loads and stores
    (D and F multiples of 4, xs and w 16-byte aligned) rather than its
    masked scalar ones."""
    return (xs.shape[1] % 4 == 0 and w.shape[2] % 4 == 0
            and xs.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def gmm_cuda(xs: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
             tm: int = 128) -> torch.Tensor:
    """K4: (Tp, F) f32 with row i = xs[i] @ w[tile_expert[i // tm]].

    ``tm`` is the row tile (the group alignment); as in the reference it
    must divide Tp, and here it must also be at most 128 or a multiple of
    128 (a CTA covers 128 rows).  The kernel covers F in 128-column tiles
    and masks the edge, so F and D take any size, except that bf16
    operands go through TMA, whose 16-byte strides need D and F to be
    multiples of 8: the wrapper raises on any other bf16 D or F.  f32
    operands run on the CUDA cores in full f32; where D and F are
    multiples of 4 and ``xs`` and ``w`` are 16-byte aligned
    (:func:`f32_vector_path`) the body loads and stores 16 bytes a
    thread, and any other D, F or offset takes its masked scalar loads
    and stores, with the same sums.  Expert ids follow the reference's
    indexing rule, in the kernel and in its plain version alike: a
    negative id counts from the end, then ids are clamped into [0, E), so
    no id reads past ``w``."""
    if xs.device.type == "cpu":
        return gmm_ref(xs, w, tile_expert, tm)
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if xs.dtype not in _SUFFIX:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    if xs.dim() != 2 or w.dim() != 3:
        raise ValueError(f"xs must be (Tp, D) and w (E, D, F), got "
                         f"{tuple(xs.shape)} and {tuple(w.shape)}")
    tp, d = xs.shape
    e, d2, f = w.shape
    if d != d2 or tp % tm or e == 0:
        raise ValueError(f"tm = {tm} must divide Tp and w must be (E, D, F)"
                         f" with E > 0: xs {tuple(xs.shape)}, w "
                         f"{tuple(w.shape)}")
    if tm > MAX_TILE and tm % MAX_TILE:
        raise ValueError(f"tm must be at most {MAX_TILE} or a multiple of "
                         f"it, got {tm}")
    check_tensor("xs", xs, dev, xs.dtype)
    check_tensor("w", w, dev, xs.dtype)
    check_tensor("tile_expert", tile_expert, dev, torch.int32, (tp // tm,))
    if xs.dtype == torch.bfloat16 and (d % 8 or f % 8 or xs.data_ptr() % 16
                                       or w.data_ptr() % 16):
        raise ValueError(f"bf16 operands need D and F multiples of 8 and "
                         f"16-byte aligned data (TMA), got D={d}, F={f}")
    out = torch.empty((tp, f), dtype=torch.float32, device=dev)
    if tp == 0 or f == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (xs.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(dev):
        if xs.dtype == torch.float32:
            name = "gmm_f32"
            err = build.entry_point(SOURCE, name, 4, 6)(
                *ptrs, tp, d, f, e, tm, int(f32_vector_path(xs, w)), stream)
        else:
            name = "gmm"
            err = build.entry_point(SOURCE, "gmm_bf16", 4, 5)(
                *ptrs, tp, d, f, e, tm, stream)
    launched(LAUNCHES, name, err)
    return out
