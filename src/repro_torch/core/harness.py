"""LiLAC-How harnesses: how detected computations are executed (paper §3.3).

Counterpart of ``repro.core.harness``.  A ``Harness`` is the executable
form of a spec's HARNESS block: a named implementation of one
What-computation, with marshaling, persistence and platform
constraints: its persistent state and its BeforeFirstExecution /
AfterLastExecution hooks (``setup`` / ``teardown``, the paper's Fig. 14
lifecycle) live on it.  This module holds the mechanism (Harness,
HarnessRegistry, the global REGISTRY) and the builtin ``torch.*`` bodies;
which harness exists, and
its formats, platforms and marshaled inputs, lives in the spec texts
(``what_lang.BUILTIN_SPECS`` plus the HARNESS blocks next to the CUDA
kernels under ``repro_torch/kernels/``).

Backends of this package:

  spmv_csr/coo  torch.segment  index_add segment-sum            (cpu + cuda)
                torch.ell      marshaled CSR->ELL repack         (host calls)
                torch.bcsr     marshaled CSR->BCSR8x128 repack   (host calls)
                torch.dense    marshaled densify                 (host calls)
                cuda.ell       marshaled CSR->ELL128, CUDA kernel (cuda)
                cuda.bcsr      marshaled CSR->BCSR128x128, CUDA kernel (cuda)
  spmv_ell/jds  torch.ell      the padded-row sum itself          (cpu)
                cuda.ell       CUDA kernel                        (cuda)
  spmm_csr      torch.segment  index_add of row windows           (cpu)
                torch.bcsr     marshaled CSR->BCSR8x128 repack   (host calls)
                cuda.bcsr      marshaled CSR->BCSR128x128, CUDA kernel (cuda)
  dotproduct    torch.dot      torch.dot                          (cpu + cuda)
  gemv          torch.dot      torch.mv                           (cpu + cuda)
  moe_ffn       torch.capacity capacity-bucket dispatch           (cpu)
                cuda.gmm       routed grouped matmul, CUDA kernel (cuda)
                dense          the naive formulation itself
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults, levels
from repro_torch.core.marshal import DataPlane

Binding = Dict[str, Any]


class DuplicateHarnessError(ValueError):
    """A harness with the same (implements, name) is already registered."""


@dataclasses.dataclass
class CallCtx:
    mode: str                      # 'trace' | 'host'
    cache: Optional[DataPlane]     # the compiled function's data plane;
                                   # None: every call repacks
    format: str                    # match format: CSR/COO/ELL/JDS/MOE
    platform: str = "cuda"
    # Selected schedule variant: tune-param name -> value.  None (or {})
    # means the harness's declared default schedule.  Set by the autotuner
    # when it sweeps or pins a variant; the generated spec wrapper merges
    # it over the defaults and passes the result to the kernel body as
    # keyword arguments.
    schedule: Optional[Dict[str, Any]] = None
    # Detected fused epilogue for this call site: 'relu' | 'silu' | 'none'
    # (bias only) | None.  Harnesses declaring ``fuse epilogue`` apply it
    # themselves (reading ``binding['bias']``); for all others the rewriter
    # applies it after the call.
    epilogue: Optional[str] = None
    # Fusion decision for this call: None = the harness's declared default
    # (fuse iff it declares ``fuse epilogue``); False pins the unfused
    # realization of a fuse-capable harness (the epilogue applies after the
    # call).  Swept as a variant dimension by the autotuner.
    fuse: Optional[bool] = None
    # The call carries gradients (rewrite.call_harness): set for a
    # trace-mode graph built for inputs that require grad, whose fake
    # values do not show it; a host-mode call reads its binding
    differentiable: bool = False


@dataclasses.dataclass
class Harness:
    name: str
    implements: str                               # What-computation name
    fn: Callable[[Binding, CallCtx], Any]
    jit_safe: bool = True                         # False: host calls only
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    formats: Tuple[str, ...] = ()                 # () = any
    # the declared ``persistent`` names, None until ``setup`` fills them;
    # the state a library keeps between calls (a handle, a workspace)
    persistent: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # declared marshal clauses (what_lang.MarshalClause)
    marshal: Tuple[Any, ...] = ()
    # declared schedule space (what_lang.TuneClause / Constraint): the
    # autotuner sweeps the variants and pins (harness, schedule) pairs.
    # Not in the registry fingerprint: a changed tune space is caught per
    # record (a pinned schedule outside the family re-tunes).
    tune: Tuple[Any, ...] = ()
    constraints: Tuple[Any, ...] = ()
    # True when the body applies detected epilogues itself
    fuse_epilogue: bool = False
    # declared backward (what_lang.VjpClause): the rewriter runs the call
    # inside one torch.autograd.Function whose backward is the registered
    # body (spec.VJPS).  None: autograd differentiates through the body,
    # right for plain torch, fatal for a repack or a ctypes launch, which
    # is why those declare one.  Not in the fingerprint
    vjp: Optional[Any] = None
    # False opts out of executable-plan baking (repro_torch.core.plan): a
    # body with per-call host-side behavior beyond its marshal clauses
    # (RNG, mutable globals, I/O) would have its first call's behavior
    # frozen into the plan.  A harness with persistent state or lifecycle
    # hooks never bakes either (pass_manager._bakeable)
    bakeable: bool = True
    setup: Optional[Callable] = None              # BeforeFirstExecution
    teardown: Optional[Callable] = None           # AfterLastExecution
    # {"up": bool}, shared by the harnesses of one HARNESS block: the
    # sibling Harness objects are one backend, so setup runs once on the
    # first call through any of them, release through any of them tears
    # down for all, and a later call sets up again
    lifecycle: Dict[str, bool] = dataclasses.field(
        default_factory=lambda: {"up": False})
    _schedules: Optional[Tuple[Dict[str, Any], ...]] = None

    @property
    def schedules(self) -> Tuple[Dict[str, Any], ...]:
        """Every constraint-satisfying assignment of the declared tune
        params, default first; empty for an untuned harness."""
        if self._schedules is None:
            from repro_torch.core.what_lang import enumerate_schedules
            self._schedules = enumerate_schedules(self.tune, self.constraints)
        return self._schedules

    @property
    def default_schedule(self) -> Dict[str, Any]:
        return {t.name: t.values[0] for t in self.tune}

    def _is_up(self) -> bool:
        return self.lifecycle["up"]

    def _mark(self, up: bool) -> None:
        self.lifecycle["up"] = up

    def __call__(self, binding: Binding, ctx: CallCtx):
        if faults.ACTIVE is not None:
            faults.fail("kernel_raise", self.name)
        if self.setup is not None and not self._is_up():
            self.setup(self.persistent)
            self._mark(True)
        key = self._batched_source(binding)
        if key is None:
            out = self.fn(binding, ctx)
        else:
            out = levels.per_element(lambda b: self.fn(b, ctx), binding, key)
        if faults.ACTIVE is not None:
            out = faults.corrupt("nan_output", self.name, out)
        return out

    def _batched_source(self, binding: Binding) -> Optional[str]:
        """The key of a marshal source that is batched at its outermost
        ``torch.func`` level (a ``vmap`` over the matrix), or None.  A
        repack reads the matrix's data, so such a call runs once an
        element (``levels.per_element``): one repack and one launch an
        element, each as an unbatched call would run them."""
        for cl in self.marshal:
            for alts in cl.keys:
                key = next((k for k in alts if k in binding), None)
                if key is not None and levels.outer_batched(binding[key]):
                    return key
        return None

    def release(self) -> None:
        """AfterLastExecution: tear the backend down if it is up (a later
        call sets it up again)."""
        if self._is_up() and self.teardown is not None:
            self.teardown(self.persistent)
            self._mark(False)


class HarnessRegistry:
    def __init__(self):
        self._by_comp: Dict[str, List[Harness]] = {}
        self._defaults: Dict[Tuple[str, str], str] = {}  # (comp, platform) -> name
        self._autotuner = None
        self._fp: Optional[str] = None
        # moves on every register: the fingerprint cannot see a same-name
        # body replaced with override=True, and a baked plan must not keep
        # running the old body
        self.epoch = 0

    def register(self, h: Harness, default_for: Tuple[str, ...] = (),
                 override: bool = False):
        """Register a harness.  Re-registering the same ``(implements,
        name)`` is an error unless ``override=True``, which replaces the
        existing harness in its candidate-order slot after running its
        AfterLastExecution hook."""
        hs = self._by_comp.setdefault(h.implements, [])
        for i, existing in enumerate(hs):
            if existing.name == h.name:
                if not override:
                    raise DuplicateHarnessError(
                        f"harness {h.name!r} is already registered for "
                        f"{h.implements!r}; pass override=True to replace it")
                existing.release()
                hs[i] = h
                break
        else:
            hs.append(h)
        for plat in default_for:
            self._defaults[(h.implements, plat)] = h.name
        self._autotuner = None        # harness set changed: new fingerprint
        self._fp = None
        self.epoch += 1
        return h

    def fingerprint(self) -> str:
        """Stable hash of the registered harness set: persisted tunings
        are dropped whenever it changes.  Memoized until the next
        ``register``."""
        if self._fp is None:
            items = sorted(
                (h.implements, h.name, h.platforms, h.formats, h.jit_safe)
                for hs in self._by_comp.values() for h in hs)
            self._fp = hashlib.blake2b(repr(items).encode(),
                                       digest_size=8).hexdigest()
        return self._fp

    @property
    def autotuner(self):
        """The registry's :class:`~repro_torch.core.autotune.Autotuner`,
        made anew when the fingerprint moves."""
        from repro_torch.core.autotune import Autotuner

        fp = self.fingerprint()
        if self._autotuner is None \
                or self._autotuner.registry_fingerprint != fp:
            self._autotuner = Autotuner(registry_fingerprint=fp)
        return self._autotuner

    def reset_autotuner(self):
        self._autotuner = None

    def _other_computations(self, comp: str, name: str) -> bool:
        """A policy naming ``name`` leaves ``comp`` on its default: ``comp``
        has no hand-written kernel (``cuda.*``) to pin, as the dot product
        and GEMV beside the SpMV that ``policy="cuda.ell"`` is about, and
        ``name`` is a harness of another computation.  A computation with a
        kernel raises ``KeyError`` for a name it does not have, as does a
        name that no computation has."""
        own = self._by_comp.get(comp, ())
        return (all(h.name != name and not h.name.startswith("cuda.")
                    for h in own)
                and any(h.name == name for hs in self._by_comp.values()
                        for h in hs))

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
               policy: str = "default",
               binding: Optional[Binding] = None,
               ctx: Optional[CallCtx] = None) -> Harness:
        """The platform default (else the first candidate) under
        ``policy='default'``; the persistent tuner's winner for this call
        signature under ``'autotune'`` (the default when it cannot measure);
        the named harness under an explicit name.  In trace mode a named
        ``host_only`` harness raises: it would marshal inside a captured
        graph."""
        cands = self.candidates(comp, fmt, platform, mode)
        if not cands:
            raise KeyError(f"no harness for {comp}/{fmt} on {platform} ({mode})")
        if policy not in ("default", "autotune") \
                and not self._other_computations(comp, policy):
            h = self.get(comp, policy)  # explicit pin by name
            if mode == "trace" and not h.jit_safe:
                raise ValueError(
                    f"harness {h.name!r} is host_only: it marshals on every "
                    f"call, which a traced graph cannot do; compile with "
                    f"mode='host' to use it")
            return h
        dname = self._defaults.get((comp, platform))
        if policy == "autotune" and binding is not None:
            if ctx is None:
                ctx = CallCtx(mode=mode, cache=DataPlane(), format=fmt,
                              platform=platform)
            h = self.autotuner.select(comp, fmt, platform, mode, cands,
                                      binding, ctx, default_name=dname)
            if h is not None:
                return h
        for h in cands:
            if h.name == dname:
                return h
        return cands[0]


REGISTRY = HarnessRegistry()


# ---------------------------------------------------------------------------
# Builtin torch.* kernel bodies.  Marshaled inputs (ell/dense keyword args)
# are produced by the repack clauses declared in the spec texts and injected
# by the generated wrapper (repro_torch.core.spec).  The forward bodies
# write out of place (``zeros(...).index_add(...)``, ``.index_put(...)``
# on a fresh buffer), so that under ``torch.func.vmap`` their ops batch.
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
    return out.index_add(0, _row_ids(b), prod)


def _ell_spmv(val, col, perm, vec):
    acc = torch.sum(val * vec[col], dim=1)
    out = torch.zeros(val.shape[0], dtype=acc.dtype, device=acc.device)
    return out.index_put((perm.long(),), acc)


def _spmv_ell_host(b: Binding, ctx: CallCtx, *, ell):
    """CSR/COO match with a marshaled ELL repack: the repack is the
    'transfer' that the cache amortizes across calls (paper Fig. 18)."""
    return _ell_spmv(ell.val, ell.col, ell.perm, b["iv"])


def _binding_to_csr(b: Binding, cols: Optional[int] = None):
    """The matched matrix as a CSR of ``cols`` columns (default: the
    vector's length)."""
    from repro_torch.sparse.formats import CSR

    if cols is None:
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


def _binding_to_csr_spmm(b: Binding):
    """Like _binding_to_csr, but the column count is the dense operand's
    leading dim (the paper's Fig. 9 ``cols`` invariant)."""
    return _binding_to_csr(b, cols=int(b["dense"].shape[0]))


def _spmv_bcsr_host(b: Binding, ctx: CallCtx, *, bcsr):
    from repro_torch.sparse.ops import bcsr_spmm_ref

    vec = torch.nn.functional.pad(b["iv"], (0, bcsr.shape[1] - b["iv"].shape[0]))
    return bcsr_spmm_ref(bcsr, vec[:, None])[: b["rows"], 0]


def _spmm_segment(b: Binding, ctx: CallCtx):
    """CSR/COO x dense matrix by an index_add of row windows."""
    prod = b["a"][:, None] * b["dense"][b["colidx"]]
    out = torch.zeros((b["rows"], prod.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add(0, _row_ids(b), prod)


def _spmm_bcsr_host(b: Binding, ctx: CallCtx, *, bcsr):
    """Marshaled CSR->BCSR repack + block SpMM (cuSPARSE csrmm analogue)."""
    from repro_torch.sparse.ops import bcsr_spmm_ref

    dense = b["dense"]
    dense = torch.nn.functional.pad(dense,
                                    (0, 0, 0, bcsr.shape[1] - dense.shape[0]))
    return bcsr_spmm_ref(bcsr, dense)[: b["rows"]]


def _spmv_dense_host(b: Binding, ctx: CallCtx, *, dense):
    return dense @ b["iv"]


def _spmv_ell_direct(b: Binding, ctx: CallCtx):
    """For matches already in ELL/JDS layout (2D val/col binding)."""
    perm = b.get("perm")
    acc = torch.sum(b["val"] * b["vector"][b["col_ind"]], dim=1)
    if perm is None:
        return acc
    out = torch.zeros(b["rows"], dtype=acc.dtype, device=acc.device)
    return out.index_put((perm,), acc)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) by comparison with ``arange(n)``: it
    traces under ``torch.func`` transforms, where ``F.one_hot``'s check of
    the index values asks a fake tensor for data."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).long()


def _moe_capacity(b: Binding, ctx: CallCtx, capacity_factor: float = 2.0):
    """Sorted capacity-bucket dispatch: compute only routed tokens.

    Naive dense-dispatch FLOPs  ~ E * T * (3 D F)
    This implementation        ~ E * C * (3 D F), C = ceil(T*K/E * cf)
    A pair past its expert's capacity C is dropped, as in the reference.
    """
    x, gate, idx = b["x"], b["gate"], b["idx"]
    wg, wu, wd = b["wg"], b["wu"], b["wd"]
    T, K = idx.shape
    E = b["experts"]
    C = max(8, min(int(np.ceil(T * K / E * capacity_factor)), T * K))
    flat_e = idx.reshape(-1).long()                             # (T*K,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_g = gate.reshape(-1)
    # position of each routed pair within its expert queue
    onehot = one_hot(flat_e, E)                                 # (TK, E)
    pos = (torch.cumsum(onehot, 0) - onehot)[
        torch.arange(T * K, device=x.device), flat_e]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)           # overflow
    xb = torch.zeros((E * C + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    xb = xb.index_put((slot,), x[flat_t])[:-1].reshape(E, C, x.shape[1])
    g = torch.einsum("ecd,edf->ecf", xb, wg)
    u = torch.einsum("ecd,edf->ecf", xb, wu)
    h = torch.nn.functional.silu(g) * u
    y = torch.einsum("ecf,efd->ecd", h, wd).reshape(E * C, -1)
    y = torch.cat([y, torch.zeros((1, y.shape[1]), dtype=y.dtype,
                                  device=y.device)])
    contrib = y[slot] * flat_g[:, None]
    out = torch.zeros((T, contrib.shape[1]), dtype=contrib.dtype,
                      device=x.device).index_add(0, flat_t, contrib)
    return out.to(x.dtype)


def _spmv_csr_bwd(b: Binding, ctx: CallCtx, primal, ct):
    """SpMV transpose-products for a CSR/COO binding: ``d_a`` is the
    per-entry product, ``d_iv`` the Aᵀ·ct scatter (itself a COO SpMV, which
    a compiled gradient re-detects).  O(nnz) in both; A is never dense."""
    r = _row_ids(b)
    return {
        "a": ct[r] * b["iv"][b["colidx"]],
        "iv": torch.zeros_like(b["iv"]).index_add(
            0, b["colidx"], b["a"] * ct[r]),
    }


def _spmv_ell_bwd(b: Binding, ctx: CallCtx, primal, ct):
    """ELL/JDS backward: a padded (val == 0) slot receives the cotangent
    product like any other slot, which is the gradient of the forward with
    respect to the padded val array."""
    perm = b.get("perm")
    dacc = ct if perm is None else ct[perm]
    col = b["col_ind"].reshape(-1)
    return {
        "val": dacc[:, None] * b["vector"][b["col_ind"]],
        "vector": torch.zeros_like(b["vector"]).index_add(
            0, col, (b["val"] * dacc[:, None]).reshape(-1)),
    }


#: entries x columns a step of _spmm_csr_bwd gathers at once (256 MB f32)
SPMM_BWD_CHUNK = 1 << 26


def _spmm_csr_bwd(b: Binding, ctx: CallCtx, primal, ct):
    """CSR SpMM backward: ``d_dense = Aᵀ·ct`` as an O(nnz·N) scatter,
    ``d_a`` the per-entry row dot.  The reference's body, taken over the
    entries in chunks of ``SPMM_BWD_CHUNK`` gathered values, so that no
    (nnz, N) gather exists whole (15 GB for HPCG-104³ x 128).  It adds
    into ``d_dense`` in place, chunk by chunk (an out-of-place add would
    copy the whole operand a chunk): under ``torch.func.vmap`` it runs only
    where the operand is batched itself, so ``zeros_like`` is batched
    too."""
    r, a, col, dense = _row_ids(b), b["a"], b["colidx"], b["dense"]
    step = max(1, SPMM_BWD_CHUNK // max(dense.shape[1], 1))
    da, dd = [], torch.zeros_like(dense)
    for s in range(0, a.shape[0], step):
        g = ct[r[s:s + step]]
        da.append(torch.sum(g * dense[col[s:s + step]], dim=-1))
        dd.index_add_(0, col[s:s + step], a[s:s + step, None] * g)
    return {"a": torch.cat(da) if da else torch.zeros_like(a), "dense": dd}


def _moe_ffn_bwd(b: Binding, ctx: CallCtx, primal, ct):
    """MoE backward by recomputing the capacity-bucket dispatch under
    ``torch.func.vjp``, as the reference does, but at a capacity that no
    expert's load exceeds, so nothing drops: the forward harnesses (K4
    over its expert-sorted rows) drop nothing either, and this is the
    exact gradient of what they compute.  The capacity is the largest
    load (one host read), E·max_load rows; in a trace, where routes have
    no values, and under ``torch.func.vmap``, where a batched route has no
    one largest load, the token count, E·T rows as in the dense
    dispatch."""
    from torch._subclasses.fake_tensor import is_fake

    idx, E = b["idx"], b["experts"]
    top = idx.shape[0]
    if not is_fake(idx) and not levels.batched(idx):
        flat = idx.reshape(-1).long()
        top = int(torch.zeros(E, dtype=torch.long, device=flat.device)
                  .index_add_(0, flat, torch.ones_like(flat)).max())

    def f(x, gate, wg, wu, wd):
        bb = dict(b)
        bb.update(x=x, gate=gate, wg=wg, wu=wu, wd=wd)
        return _moe_capacity(bb, ctx, capacity_factor=top * E / idx.numel())

    _, pull = torch.func.vjp(f, b["x"], b["gate"], b["wg"], b["wu"], b["wd"])
    gx, gg, gwg, gwu, gwd = pull(ct.to(b["x"].dtype))
    return {"x": gx, "gate": gg, "wg": gwg, "wu": gwu, "wd": gwd}


#: Backward bodies for ``vjp`` clauses, keyed by the name a clause cites
#: (``repro_torch.core.spec`` enters them into its VJPS registry).
BUILTIN_VJPS: Dict[str, Callable] = {
    "spmv_csr_bwd": _spmv_csr_bwd,
    "spmv_ell_bwd": _spmv_ell_bwd,
    "spmm_csr_bwd": _spmm_csr_bwd,
    "moe_ffn_bwd": _moe_ffn_bwd,
}


def _moe_dense(b: Binding, ctx: CallCtx):
    """The naive formulation itself — the paper's '-O2 baseline' harness."""
    x, gate, idx = b["x"], b["gate"], b["idx"]
    onehot = one_hot(idx, b["experts"]).to(x.dtype)
    combine = torch.einsum("tke,tk->te", onehot, gate.to(x.dtype))
    g = torch.einsum("td,edf->etf", x, b["wg"])
    u = torch.einsum("td,edf->etf", x, b["wu"])
    h = torch.nn.functional.silu(g) * u
    y = torch.einsum("etf,efd->etd", h, b["wd"])
    return torch.einsum("te,etd->td", combine, y)


def _dot(b: Binding, ctx: CallCtx):
    dt = torch.result_type(b["a"], b["b"])
    return torch.dot(b["a"].to(dt), b["b"].to(dt))


def _gemv(b: Binding, ctx: CallCtx):
    dt = torch.result_type(b["mat"], b["vec"])
    return torch.mv(b["mat"].to(dt), b["vec"].to(dt))


# Kernel bodies for the builtin spec texts, keyed by spec family then by
# harness name (repro_torch.core.spec.register_builtins consumes this).
BUILTIN_BODIES: Dict[str, Dict[str, Callable]] = {
    "spmv": {
        "torch.segment": _spmv_segment,
        "torch.ell": _spmv_ell_host,
        "torch.bcsr": _spmv_bcsr_host,
        "torch.dense": _spmv_dense_host,
    },
    "spmv_padded": {"torch.ell": _spmv_ell_direct},
    "spmm": {"torch.segment": _spmm_segment, "torch.bcsr": _spmm_bcsr_host},
    "dotproduct": {"torch.dot": _dot},
    "gemv": {"torch.dot": _gemv},
    "moe_ffn": {"torch.capacity": _moe_capacity},
    "moe_ffn_baseline": {"dense": _moe_dense},
}
