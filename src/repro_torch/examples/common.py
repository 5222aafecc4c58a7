"""What the examples share: the application's naive CSR SpMV, the
command-line options, the compiled naive baseline, and a synchronised
wall clock."""
from __future__ import annotations

import argparse
import time

import torch


def naive_spmv(val, col, row_ptr, v):
    """The application's textbook CSR SpMV, written naively."""
    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def parser(doc: str, policy: str = "default") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--policy", default=policy,
                    help="default | autotune | a harness name")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def compiled(fn, device):
    """``fn`` under ``torch.compile`` (one graph), as the reference jits
    its baseline: inductor on the card, aot_eager on the CPU."""
    from repro_torch.core import jit

    return jit.Entry(fn, jit.backend_for(device),
                     name=f"{fn.__name__} (compiled)")


def seconds(fn, device) -> tuple:
    """(result, wall seconds) of ``fn()``, to the end of its device work."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
