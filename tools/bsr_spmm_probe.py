#!/usr/bin/env python3
"""Where K3's wide body spends its time on one NVIDIA GPU.

    python3 tools/bsr_spmm_probe.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It builds variants of the wide body of
``src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu`` with ``nvcc`` into
``build/bsr_spmm_probe/``, each with one part switched off by a guard this
script inserts at fixed places of the source (it stops if a place is
missing), and times each (CUDA events, 10 launches after one) on HPCG's
27-point operator over 104^3 points in packed 128x128 tiles times an f32
operand of 128 columns, the GNN path's call:

* ``as_built``: the kernel as the port runs it (runs of 4 block rows);
* ``no_products``: the consumers skip the products, so the time is the
  staging's (TMA copies of the used operand rows) and the pipeline's;
* ``no_staging``: the producer copies nothing, so the time is the
  products' (on whatever the stages hold) and the pipeline's;
* ``long_runs`` / ``long_runs_no_products``: one CTA an SM, each walking
  ~1/132 of the block rows, so the CTAs on the card at a time are spread
  over the whole matrix instead of covering neighbouring block rows.

The variants' outputs are not checked (two of them compute nothing).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu"
OUT = ROOT / "build/bsr_spmm_probe"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
VARIANTS = {
    "as_built": [],
    "no_products": ["-DPROBE_NO_PRODUCTS"],
    "no_staging": ["-DPROBE_NO_STAGING"],
    "long_runs": ["-DPROBE_RUN_ROWS=67"],
    "long_runs_no_products": ["-DPROBE_RUN_ROWS=67", "-DPROBE_NO_PRODUCTS"],
}
# (text of the source, what it becomes in the probe's copy)
GUARDS = [
    ("constexpr int kRunRows = 4;",
     "#ifndef PROBE_RUN_ROWS\n#define PROBE_RUN_ROWS 4\n#endif\n"
     "constexpr int kRunRows = PROBE_RUN_ROWS;"),
    ("      const uint4 copied = mask_below(mask, rows_in);\n",
     "      uint4 copied = mask_below(mask, rows_in);\n#ifdef PROBE_NO_STAGING\n"
     "      copied = make_uint4(0, 0, 0, 0);\n#endif\n"),
    ("    for (int c0 = bound[0]; c0 < bound[kRows]; c0 += 32) {\n",
     "#ifndef PROBE_NO_PRODUCTS\n"
     "    for (int c0 = bound[0]; c0 < bound[kRows]; c0 += 32) {\n"),
    ("      v = v2;\n      loc = loc2;\n    }\n",
     "      v = v2;\n      loc = loc2;\n    }\n#endif\n"),
]


def probe_source() -> Path:
    text = SOURCE.read_text()
    for place, guarded in GUARDS:
        if text.count(place) != 1:
            raise SystemExit(f"bsr_spmm_probe: the source no longer holds "
                             f"{place.strip()!r} once; update GUARDS")
        text = text.replace(place, guarded)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "bsr_spmm_probe.cu"
    path.write_text(text)
    return path


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.build import nvcc
    from repro_torch.sparse.convert import csr_to_packed_bcsr
    from repro_torch.sparse.random import stencil27_csr

    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    src = probe_source()
    builds = {name: subprocess.Popen(
        [nvcc(), *FLAGS, *flags, "-o", str(OUT / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"bsr_spmm_probe: nvcc failed for {name}")

    dev = torch.device("cuda")
    csr = stencil27_csr(104, 104, 104, device=dev)
    p = csr_to_packed_bcsr(csr, (128, 128))
    n = 128
    h = torch.randn(csr.cols, n, device=dev)
    out = torch.empty(csr.rows, n, device=dev)
    print(f"HPCG-104^3: {p.nblocks} tiles, {p.nnz} entries; N = {n}")
    for name in VARIANTS:
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).bsr_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        args = (p.val.data_ptr(), p.local.data_ptr(), p.tile_ptr.data_ptr(),
                p.row_start.data_ptr(), p.col_mask.data_ptr(),
                p.block_col.data_ptr(), p.block_rowptr.data_ptr(),
                h.data_ptr(), None, out.data_ptr(), 128, 128, csr.cols, n, n,
                csr.rows, 0, 0, torch.cuda.current_stream().cuda_stream)
        if fn(*args):
            raise SystemExit(f"bsr_spmm_probe: {name} failed to launch")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        print(f"{name}: {start.elapsed_time(end) / 10:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
