"""Build CUDA sources into shared libraries with a plain C interface and
load them with ctypes.

Each ``csrc/*.cu`` file compiles on its own with ``nvcc`` for ``sm_90a``
into ``build/repro_torch/lib<stem>-<digest>.so`` at the repository root,
where the digest covers the source bytes and the flags, so an edited
source builds anew and an unchanged one is reused.  Nothing builds at
import: the first call that needs a kernel builds it.  ``nvcc`` exists
only where the CUDA toolkit is installed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[Path, str], Callable] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start(source: Path):
    """Start nvcc for ``source`` unless its library exists: (path, process
    or None).  The output goes to a temporary name and is renamed into
    place, so a concurrent build never loads a half-written library."""
    out = library_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(out: Path, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_all(sources: Iterable[Path]) -> List[Path]:
    """Build every source, one nvcc each, all started together."""
    started = [_start(Path(s)) for s in sources]
    return [_finish(out, proc) for out, proc in started]


def build_log(source: Path) -> str:
    """What nvcc printed for the built library (ptxas register and
    shared-memory lines), or '' if it was built by an earlier process."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: Path) -> ctypes.CDLL:
    """The built library for ``source``, building it on first use."""
    (path,) = build_all([source])
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib


def entry_point(source: Path, name: str, n_ptrs: int, n_ints: int):
    """The C function ``name`` of ``source``'s library, taking ``n_ptrs``
    pointers, then ``n_ints`` ints, then the stream, and returning the
    launch's cudaError; built and loaded on first use (later calls cost
    one dict lookup)."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[(source, name)] = fn
    return fn
