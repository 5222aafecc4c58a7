"""LiLAC-How harnesses: how detected computations are executed (paper §3.3).

Counterpart of ``repro.core.harness``.  A ``Harness`` is the executable
form of a spec's HARNESS block: a named implementation of one
What-computation, with marshaling and platform constraints.  This module
holds the mechanism (Harness, HarnessRegistry, the global REGISTRY) and the
builtin ``torch.*`` bodies of the SpMV families; which harness exists, and
its formats, platforms and marshaled inputs, lives in the spec texts
(``what_lang.BUILTIN_SPECS`` plus the HARNESS blocks next to the CUDA
kernels under ``repro_torch/kernels/``).

Backends of this package:

  spmv_csr/coo  torch.segment  index_add segment-sum            (cpu + cuda)
                torch.ell      marshaled CSR->ELL repack         (host calls)
                torch.dense    marshaled densify                 (host calls)
                cuda.ell       marshaled CSR->ELL128, CUDA kernel (cuda)
  spmv_ell/jds  torch.ell      the padded-row sum itself          (cpu)
                cuda.ell       CUDA kernel                        (cuda)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.marshal import DataPlane

Binding = Dict[str, Any]


class DuplicateHarnessError(ValueError):
    """A harness with the same (implements, name) is already registered."""


@dataclasses.dataclass
class CallCtx:
    mode: str                      # 'host' (trace mode is a later slice)
    cache: DataPlane               # the compiled function's data plane
    format: str                    # match format: CSR/COO/ELL/JDS
    platform: str = "cuda"
    # Detected fused epilogue for this call site: 'relu' | 'silu' | 'none'
    # (bias only) | None.  Harnesses declaring ``fuse epilogue`` apply it
    # themselves (reading ``binding['bias']``); for all others the rewriter
    # applies it after the call.
    epilogue: Optional[str] = None


@dataclasses.dataclass
class Harness:
    name: str
    implements: str                               # What-computation name
    fn: Callable[[Binding, CallCtx], Any]
    jit_safe: bool = True                         # False: host calls only
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    formats: Tuple[str, ...] = ()                 # () = any
    # declared marshal clauses (what_lang.MarshalClause)
    marshal: Tuple[Any, ...] = ()
    # True when the body applies detected epilogues itself
    fuse_epilogue: bool = False

    def __call__(self, binding: Binding, ctx: CallCtx):
        return self.fn(binding, ctx)


class HarnessRegistry:
    def __init__(self):
        self._by_comp: Dict[str, List[Harness]] = {}
        self._defaults: Dict[Tuple[str, str], str] = {}  # (comp, platform) -> name

    def register(self, h: Harness, default_for: Tuple[str, ...] = (),
                 override: bool = False):
        """Register a harness.  Re-registering the same ``(implements,
        name)`` is an error unless ``override=True``, which replaces the
        existing harness in its candidate-order slot."""
        hs = self._by_comp.setdefault(h.implements, [])
        for i, existing in enumerate(hs):
            if existing.name == h.name:
                if not override:
                    raise DuplicateHarnessError(
                        f"harness {h.name!r} is already registered for "
                        f"{h.implements!r}; pass override=True to replace it")
                hs[i] = h
                break
        else:
            hs.append(h)
        for plat in default_for:
            self._defaults[(h.implements, plat)] = h.name
        return h

    def default_name(self, comp: str, platform: str) -> Optional[str]:
        return self._defaults.get((comp, platform))

    def harnesses_for(self, comp: str) -> List[Harness]:
        return list(self._by_comp.get(comp, []))

    def get(self, comp: str, name: str) -> Harness:
        for h in self._by_comp.get(comp, []):
            if h.name == name:
                return h
        raise KeyError(f"no harness {name!r} for {comp!r}")

    def candidates(self, comp: str, fmt: str, platform: str,
                   mode: str) -> List[Harness]:
        out = []
        for h in self._by_comp.get(comp, []):
            if platform not in h.platforms:
                continue
            if h.formats and fmt not in h.formats:
                continue
            if mode == "trace" and not h.jit_safe:
                continue
            out.append(h)
        return out

    def select(self, comp: str, fmt: str, platform: str, mode: str,
               policy: str = "default") -> Harness:
        """The platform default (else the first candidate) under
        ``policy='default'``; the named harness under an explicit name."""
        cands = self.candidates(comp, fmt, platform, mode)
        if not cands:
            raise KeyError(f"no harness for {comp}/{fmt} on {platform} ({mode})")
        if policy != "default":
            return self.get(comp, policy)  # explicit pin by name
        dname = self._defaults.get((comp, platform))
        for h in cands:
            if h.name == dname:
                return h
        return cands[0]


REGISTRY = HarnessRegistry()


# ---------------------------------------------------------------------------
# Builtin torch.* kernel bodies.  Marshaled inputs (ell/dense keyword args)
# are produced by the repack clauses declared in the spec texts and injected
# by the generated wrapper (repro_torch.core.spec).
# ---------------------------------------------------------------------------

def _row_ids(binding: Binding) -> torch.Tensor:
    """CSR binding carries `rowstr`; COO carries `rowidx`."""
    if "rowidx" in binding:
        return binding["rowidx"]
    row_ptr = binding["rowstr"]
    return torch.repeat_interleave(
        torch.arange(binding["rows"], device=row_ptr.device),
        torch.diff(row_ptr).long(), output_size=binding["nnz"])


def _spmv_segment(b: Binding, ctx: CallCtx):
    prod = b["a"] * b["iv"][b["colidx"]]
    out = torch.zeros(b["rows"], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, _row_ids(b), prod)


def _ell_spmv(val, col, perm, vec):
    acc = torch.sum(val * vec[col], dim=1)
    out = torch.zeros(val.shape[0], dtype=acc.dtype, device=acc.device)
    out[perm.long()] = acc
    return out


def _spmv_ell_host(b: Binding, ctx: CallCtx, *, ell):
    """CSR/COO match with a marshaled ELL repack: the repack is the
    'transfer' that the cache amortizes across calls (paper Fig. 18)."""
    return _ell_spmv(ell.val, ell.col, ell.perm, b["iv"])


def _binding_to_csr(b: Binding):
    from repro_torch.sparse.formats import CSR

    cols = int(b["iv"].shape[0])
    if "rowstr" in b:
        return CSR(val=b["a"], col_ind=b["colidx"], row_ptr=b["rowstr"],
                   shape=(b["rows"], cols))
    # COO -> CSR on the host (sorted by row)
    row = b["rowidx"].cpu().numpy()
    order = np.argsort(row, kind="stable")
    dev = b["a"].device
    val = b["a"].cpu().numpy()[order]
    col = b["colidx"].cpu().numpy()[order].astype(np.int32)
    counts = np.bincount(row, minlength=b["rows"])
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSR(val=torch.from_numpy(val).to(dev),
               col_ind=torch.from_numpy(col).to(dev),
               row_ptr=torch.from_numpy(row_ptr).to(dev),
               shape=(b["rows"], cols))


def _spmv_dense_host(b: Binding, ctx: CallCtx, *, dense):
    return dense @ b["iv"]


def _spmv_ell_direct(b: Binding, ctx: CallCtx):
    """For matches already in ELL/JDS layout (2D val/col binding)."""
    perm = b.get("perm")
    acc = torch.sum(b["val"] * b["vector"][b["col_ind"]], dim=1)
    if perm is None:
        return acc
    out = torch.zeros(b["rows"], dtype=acc.dtype, device=acc.device)
    out[perm] = acc
    return out


# Kernel bodies for the builtin spec texts, keyed by spec family then by
# harness name (repro_torch.core.spec.register_builtins consumes this).
# A HARNESS block without a body here (torch.bcsr and the SpMM, dot, gemv
# and MoE families) is not registered yet.
BUILTIN_BODIES: Dict[str, Dict[str, Callable]] = {
    "spmv": {
        "torch.segment": _spmv_segment,
        "torch.ell": _spmv_ell_host,
        "torch.dense": _spmv_dense_host,
    },
    "spmv_padded": {"torch.ell": _spmv_ell_direct},
}
