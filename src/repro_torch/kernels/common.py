"""Helpers shared by the kernel packages.

Counterpart of ``repro.kernels.common``.  ``apply_epilogue_inregister``
has two forms: this plain torch function, and the ``__device__`` function
``epilogue_inregister`` in each CUDA source, which applies the same chain
to the accumulator before the kernel's single store.  ``EPILOGUE_CODES``
is the integer a wrapper passes for the chain.  The Mosaic-only
``compiler_params`` has no counterpart: a CUDA kernel's launch shape is set
by its wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

#: epilogue name -> the code the CUDA kernels take ('none' = bias only).
EPILOGUE_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2}


def apply_epilogue_inregister(acc: torch.Tensor, bias, epilogue: Optional[str]):
    """The epilogue: bias add then activation ('relu' | 'silu'; 'none' or
    None is bias only).  ``repro_torch.core.rewrite.apply_epilogue`` is this
    function, so the fused and unfused realizations cannot drift apart."""
    if bias is not None:
        acc = acc + bias
    if epilogue == "relu":
        acc = torch.clamp_min(acc, 0)
    elif epilogue == "silu":
        acc = acc * torch.sigmoid(acc)
    return acc
