"""LiLAC spec compilation: How-descriptors -> executable harnesses (§3.3).

Counterpart of ``repro.core.spec``.  A library implementer writes a
HARNESS block and a kernel body; this module does the rest:

* ``build_harnesses`` turns a parsed ``HarnessDecl`` plus a body into
  registered :class:`~repro_torch.core.harness.Harness` objects.  The
  marshaling wrapper is *generated* from the declared ``marshal`` clauses,
  which route each repack through the call's data plane.
* ``@harness(...)`` is the decorator form (see
  ``repro_torch/kernels/*/harness.py``).
* ``@repack(name)`` / ``@hook(name)`` register the format conversions
  and the BeforeFirstExecution / AfterLastExecution functions that spec
  texts name (``hooks=`` passes more for one registration).
* ``register_builtins`` populates the registry from the builtin spec
  texts plus the HARNESS blocks next to the CUDA kernels; given a fresh
  registry, it replays every spec registered against the global one.

``tune`` and ``constraint`` clauses declare a harness's schedule space:
the constraint-filtered variants, default first, are enumerated when the
harness registers, and the selected variant reaches the kernel body as
keyword arguments.  A ``vjp <name>(<wrt>)`` clause names a backward body
registered with ``@vjp(name)`` (the builtin ones are
``harness.BUILTIN_VJPS``): the rewriter runs such a harness inside one
``torch.autograd.Function`` whose backward is that body
(``rewrite.call_harness``).

``persistent`` names, ``BeforeFirstExecution`` and ``AfterLastExecution``
are the paper's Fig. 14 lifecycle: the harnesses of one block share one
persistent dict and one lifecycle flag, so ``setup(persistent)`` runs
once before the first call through any of them and ``teardown`` once on
``release`` (or when ``register(..., override=True)`` replaces the
backend).  Such a harness never bakes into a plan: its state is read on
every call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.core import harness as H
from repro_torch.core import marshal as M
from repro_torch.core import what_lang as W


class SpecError(ValueError):
    """A spec references something the How-compiler cannot resolve."""


REPACKS: Dict[str, Callable[[H.Binding], Any]] = {}
HOOKS: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
VJPS: Dict[str, Callable] = {}


def repack(name: str, *, override: bool = False):
    """Register a marshaling repack function ``binding -> packed value``
    under ``name`` so ``marshal x = name(...)`` clauses can refer to it."""
    def deco(fn):
        if name in REPACKS and REPACKS[name] is not fn and not override:
            raise SpecError(f"repack {name!r} is already registered")
        REPACKS[name] = fn
        return fn
    return deco


def hook(name: str, *, override: bool = False):
    """Register a persistence hook ``persistent_state_dict -> None`` so
    BeforeFirstExecution / AfterLastExecution clauses can refer to it."""
    def deco(fn):
        if name in HOOKS and HOOKS[name] is not fn and not override:
            raise SpecError(f"hook {name!r} is already registered")
        HOOKS[name] = fn
        return fn
    return deco


def vjp(name: str, *, override: bool = False):
    """Register a backward body so ``vjp <name>(wrt...)`` clauses can refer
    to it.  Its signature::

        bwd(binding, ctx, primal_out, cotangent) -> {wrt_key: grad, ...}

    It runs in autograd's backward pass (or under ``torch.func``), so it is
    plain torch on the cotangent, the wrt binding values and whatever index
    structure the binding holds.  It must return a gradient for every
    declared wrt key that requires one."""
    def deco(fn):
        if name in VJPS and VJPS[name] is not fn and not override:
            raise SpecError(f"vjp {name!r} is already registered")
        VJPS[name] = fn
        return fn
    return deco


# The builtin backward bodies enter the registry at import, so any HARNESS
# block (builtin spec text or kernel package) can cite them.
VJPS.update(H.BUILTIN_VJPS)


# ---------------------------------------------------------------------------
# Descriptor -> Harness compilation
# ---------------------------------------------------------------------------

def _resolve_key(binding: H.Binding, alternatives) -> Any:
    for k in alternatives:
        if k in binding:
            return binding[k]
    raise KeyError(
        f"marshal key {'|'.join(alternatives)!r} not found in binding "
        f"(has {sorted(binding)})")


def _marshaled_fn(decl: W.HarnessDecl, body: Callable) -> Callable:
    """Generate the execution wrapper for a HARNESS descriptor: marshaled
    inputs and the tuned schedule arrive at the kernel body as keyword
    arguments.

    *Marshal clauses*: a clause with ``from <src> to <dst>`` goes through
    the data plane's conversion graph, with the clause's repack as the
    fallback; without a data plane (``marshal_policy='off'``) every call
    repacks.

    *Tune clauses*: the body receives every declared tune param: the
    default schedule (first declared values) overlaid with
    ``ctx.schedule``, which is how the autotuner's winner reaches the
    kernel.  An unknown schedule key raises: a pinned variant must never
    silently do nothing."""
    clauses = decl.marshal
    default_schedule = decl.default_schedule()
    tune_names = frozenset(default_schedule)

    def fn(binding: H.Binding, ctx: H.CallCtx):
        marshaled = {}
        cache = ctx.cache
        for cl in clauses:
            pack = REPACKS[cl.repack]
            keys = tuple(_resolve_key(binding, alts) for alts in cl.keys)
            if cache is None:
                marshaled[cl.name] = pack(binding)
            elif cl.src and cl.dst:
                marshaled[cl.name] = cache.ensure(
                    cl.src, cl.dst, keys, binding,
                    fallback=lambda p=pack: p(binding))
            else:
                marshaled[cl.name] = cache.get(
                    cl.repack, keys, lambda p=pack: p(binding))
        if tune_names:
            sched = dict(default_schedule)
            if ctx.schedule:
                unknown = set(ctx.schedule) - tune_names
                if unknown:
                    raise SpecError(
                        f"harness {decl.name!r}: schedule has unknown "
                        f"param(s) {sorted(unknown)} "
                        f"(declared: {sorted(tune_names)})")
                sched.update(ctx.schedule)
            marshaled.update(sched)
        return body(binding, ctx, **marshaled)

    fn.__name__ = getattr(body, "__name__", decl.name)
    fn.__qualname__ = getattr(body, "__qualname__", decl.name)
    return fn


def _hook(decl: W.HarnessDecl, table: Dict[str, Callable],
          name: Optional[str], clause: str) -> Optional[Callable]:
    if name is None:
        return None
    fn = table.get(name)
    if fn is None:
        raise SpecError(f"harness {decl.name!r}: unknown {clause} hook "
                        f"{name!r}")
    return fn


def build_harnesses(decl: W.HarnessDecl, body: Callable, *,
                    hooks: Optional[Dict[str, Callable]] = None,
                    ) -> List[H.Harness]:
    """Compile one HARNESS descriptor + kernel body into Harness objects
    (one per implemented computation).  Hook names resolve against
    ``hooks``, then the registered ``HOOKS``."""
    table = {**HOOKS, **(hooks or {})}
    setup = _hook(decl, table, decl.before_first, "BeforeFirstExecution")
    teardown = _hook(decl, table, decl.after_last, "AfterLastExecution")
    # Enumerate the schedule family now: a tune/constraint mistake (a
    # constraint that cannot be evaluated, or one that prunes the default
    # schedule) fails at registration, not mid-sweep inside the autotuner.
    schedules = ()
    if decl.tune:
        try:
            schedules = W.enumerate_schedules(decl.tune, decl.constraints)
        except W.ParseError as e:
            raise SpecError(f"harness {decl.name!r}: {e}")
        if not schedules or schedules[0] != decl.default_schedule():
            raise SpecError(
                f"harness {decl.name!r}: the default schedule (first "
                f"declared values) violates a constraint")
    fn = _marshaled_fn(decl, body) if (decl.marshal or decl.tune) else body
    # one block is one backend, however many computations it implements:
    # its harnesses share the persistent dict and the lifecycle flag
    persistent = {k: None for k in decl.persistent}
    lifecycle = {"up": False}
    return [
        H.Harness(decl.name, comp, fn, jit_safe=decl.jit_safe,
                  platforms=decl.platforms, formats=decl.formats,
                  persistent=persistent, setup=setup, teardown=teardown,
                  lifecycle=lifecycle, marshal=decl.marshal, tune=decl.tune,
                  constraints=decl.constraints,
                  fuse_epilogue=decl.fuse_epilogue, vjp=decl.vjp,
                  _schedules=schedules or None)
        for comp in decl.implements
    ]


# Every spec registered against the global REGISTRY is logged, so that
# register_builtins can replay the whole builtin surface into a fresh
# registry.
_GLOBAL_SPEC_LOG: List[tuple] = []


def register_spec(spec: Union[str, W.Spec], bodies: Dict[str, Callable], *,
                  registry: Optional[H.HarnessRegistry] = None,
                  hooks: Optional[Dict[str, Callable]] = None,
                  override: bool = False) -> List[H.Harness]:
    """Register a full LiLAC spec: new computations go to the What-language
    builtins (rebuilding the default detector), and every HARNESS block is
    compiled against its kernel body from ``bodies`` and registered."""
    if isinstance(spec, str):
        spec = W.parse_spec(spec)
    reg = registry if registry is not None else H.REGISTRY
    is_global = reg is H.REGISTRY

    # Phase 1 — validate and build with NO side effects, so a bad spec
    # raises without leaving a prefix of it registered.
    local_comps = {c.name for c in spec.computations}
    for comp in spec.computations:
        known = W.BUILTINS.get(comp.name)
        if known is not None and known != comp:
            raise SpecError(
                f"computation {comp.name!r} conflicts with an existing "
                f"definition; rename it or match the builtin text")
    staged: List[tuple] = []    # (decl, [Harness, ...])
    seen: set = set()           # (implements, name) within this spec
    for decl in spec.harnesses:
        for target in decl.implements:
            if target not in W.BUILTINS and target not in local_comps:
                raise SpecError(
                    f"HARNESS {decl.name!r} implements unknown computation "
                    f"{target!r}")
        body = bodies.get(decl.name)
        if body is None:
            raise SpecError(
                f"no kernel body bound for HARNESS {decl.name!r} "
                f"(bodies has {sorted(bodies)})")
        if decl.vjp is not None and decl.vjp.name not in VJPS:
            # like a repack: a misspelt backward fails at registration,
            # not the first time someone differentiates
            raise SpecError(
                f"HARNESS {decl.name!r}: unknown vjp {decl.vjp.name!r} "
                f"(register it with @vjp before the harness)")
        for cl in decl.marshal:
            if cl.repack not in REPACKS:
                raise SpecError(
                    f"HARNESS {decl.name!r}: unknown repack {cl.repack!r} "
                    f"(register it with @repack before the harness)")
            if cl.src is not None and cl.src not in M.SOURCES:
                raise SpecError(
                    f"HARNESS {decl.name!r}: unknown marshal source "
                    f"{cl.src!r} (register it with register_source)")
            if cl.dst is not None and cl.dst not in M.FORMATS:
                raise SpecError(
                    f"HARNESS {decl.name!r}: unknown marshal target format "
                    f"{cl.dst!r} (register it with register_format)")
            if cl.src is not None and cl.dst is not None:
                start = M.SOURCES[cl.src].fmt
                if M.GRAPH.full_path_cost(start, cl.dst) is None:
                    raise SpecError(
                        f"HARNESS {decl.name!r}: no conversion path "
                        f"{cl.src}({start}) -> {cl.dst} in the graph")
        hs = build_harnesses(decl, body, hooks=hooks)
        for h in hs:
            key = (h.implements, h.name)
            already = any(ex.name == h.name
                          for ex in reg.harnesses_for(h.implements))
            if key in seen or (already and not override):
                raise H.DuplicateHarnessError(
                    f"harness {h.name!r} is already registered for "
                    f"{h.implements!r}; pass override=True to replace it")
            seen.add(key)
        staged.append((decl, hs))

    # Phase 2 — commit.  The global registry publishes new computations
    # to the What-language builtins (and rebuilds the default detector); a
    # caller-supplied registry stays isolated.
    new_comp = False
    for comp in spec.computations:
        if comp.name not in W.BUILTINS and is_global:
            W.BUILTINS[comp.name] = comp
            new_comp = True
    if new_comp:
        from repro_torch.core import detect as D
        D.reset_default_detector()
    registered: List[H.Harness] = []
    for decl, hs in staged:
        for h in hs:
            reg.register(h, default_for=decl.default_for, override=override)
            registered.append(h)
    if is_global:
        _GLOBAL_SPEC_LOG.append((spec, dict(bodies), dict(hooks or {})))
    return registered


def harness(decl: Union[str, W.HarnessDecl], *,
            registry: Optional[H.HarnessRegistry] = None,
            hooks: Optional[Dict[str, Callable]] = None,
            override: bool = False):
    """Decorator: compile and register the kernel body under a HARNESS
    declaration (text or parsed)::

        @lilac.harness('''
        HARNESS cuda.ell implements spmv_ell, spmv_jds
          formats ELL, JDS;
          default_for cuda;
        ''')
        def cuda_ell(binding, ctx):
            ...
    """
    if isinstance(decl, W.HarnessDecl):
        spec = W.Spec((), (decl,))
    else:
        spec = W.parse_spec(decl)
    if len(spec.harnesses) != 1:
        raise SpecError("@harness expects exactly one HARNESS block")
    name = spec.harnesses[0].name

    def deco(body):
        register_spec(spec, {name: body}, registry=registry, hooks=hooks,
                      override=override)
        return body

    return deco


# ---------------------------------------------------------------------------
# The builtin data plane: the source loaders (binding -> CSR) and the
# conversion edges the harnesses name; the repack functions below are the
# single-hop fallbacks.
# ---------------------------------------------------------------------------

M.register_source("csr_binding", "CSR", H._binding_to_csr)
M.register_source("csr_binding_mm", "CSR", H._binding_to_csr_spmm)


@M.edge("CSR", "ELL8", name="csr_to_ell8")
def _csr_to_ell8(csr):
    from repro_torch.sparse.convert import csr_to_ell
    return csr_to_ell(csr)


@M.edge("CSR", "ELL128", name="csr_to_ell128")
def _csr_to_ell128(csr):
    from repro_torch.kernels.spmv_ell.ops import pack_ell128
    return pack_ell128(csr)


@M.edge("CSR", "DENSE", name="csr_todense")
def _csr_todense(csr):
    return csr.todense()


@M.edge("CSR", "JDS", name="csr_to_jds")
def _csr_to_jds(csr):
    from repro_torch.sparse.convert import csr_to_jds
    return csr_to_jds(csr)


@M.edge("CSR", "BCSR8x128", name="csr_to_bcsr8x128")
def _csr_to_bcsr8(csr):
    from repro_torch.sparse.convert import csr_to_bcsr
    return csr_to_bcsr(csr, (8, 128))


@M.edge("CSR", "BCSR128x128", name="csr_to_bcsr128x128")
def _csr_to_bcsr128(csr):
    """The packed tiles that ``cuda.bcsr``'s kernel reads."""
    from repro_torch.sparse.convert import csr_to_packed_bcsr
    return csr_to_packed_bcsr(csr, (128, 128))


def _dense_to_bcsr(dense, block_shape):
    """Pad to block multiples and tile: the reference's second hop of
    CSR -> DENSE -> BCSR, kept for a source that is dense (the planner
    never densifies a CSR on the way to BCSR, marshal.NO_TRANSIT)."""
    from repro_torch.sparse.formats import bcsr_from_dense
    bm, bk = block_shape
    rows, cols = dense.shape
    dense = torch.nn.functional.pad(dense, (0, (-cols) % bk, 0, (-rows) % bm))
    return bcsr_from_dense(dense, block_shape)


@M.edge("DENSE", "BCSR8x128", name="dense_to_bcsr8x128")
def _dense_to_bcsr8(dense):
    return _dense_to_bcsr(dense, (8, 128))


@M.edge("DENSE", "BCSR128x128", name="dense_to_bcsr128x128")
def _dense_to_bcsr128(dense):
    from repro_torch.sparse.formats import pack_bcsr
    return pack_bcsr(_dense_to_bcsr(dense, (128, 128)))


@repack("ell_pack")
def _ell_pack(b: H.Binding):
    return _csr_to_ell8(H._binding_to_csr(b))


@repack("ell_pack128")
def _ell_pack128(b: H.Binding):
    return _csr_to_ell128(H._binding_to_csr(b))


@repack("bcsr_pack")
def _bcsr_pack(b: H.Binding):
    return _csr_to_bcsr8(H._binding_to_csr(b))


@repack("bcsr_pack128")
def _bcsr_pack128(b: H.Binding):
    return _csr_to_bcsr128(H._binding_to_csr(b))


@repack("bcsr_pack_mm")
def _bcsr_pack_mm(b: H.Binding):
    return _csr_to_bcsr8(H._binding_to_csr_spmm(b))


@repack("bcsr_pack_mm128")
def _bcsr_pack_mm128(b: H.Binding):
    return _csr_to_bcsr128(H._binding_to_csr_spmm(b))


@repack("densify")
def _densify(b: H.Binding):
    return H._binding_to_csr(b).todense()


# ---------------------------------------------------------------------------
# Builtin registration
# ---------------------------------------------------------------------------

_builtins_done = False


def register_builtins(registry: Optional[H.HarnessRegistry] = None
                      ) -> H.HarnessRegistry:
    """Populate the global REGISTRY from the builtin spec texts (the
    HARNESS blocks that have a body in ``harness.BUILTIN_BODIES``), then
    the CUDA kernels' own HARNESS blocks, then the families that must come
    after them (``what_lang.POST_KERNEL_FAMILIES``): candidate order is
    registration order.  Given another registry, replay every spec the
    global one logged into it (with override=True, so a spec re-loaded
    globally with override ends as it did there), each harness a new
    object with its own persistent state."""
    global _builtins_done
    if registry is not None and registry is not H.REGISTRY:
        register_builtins()
        for spec, bodies, hooks in list(_GLOBAL_SPEC_LOG):
            register_spec(spec, bodies, registry=registry, hooks=hooks,
                          override=True)
        return registry
    if _builtins_done:
        return H.REGISTRY

    def family(name):
        bodies = H.BUILTIN_BODIES[name]
        spec = W.parse_spec(W.BUILTIN_SPECS[name])
        spec = W.Spec(spec.computations,
                      tuple(h for h in spec.harnesses if h.name in bodies))
        register_spec(spec, bodies, override=True)

    for name in H.BUILTIN_BODIES:
        if name not in W.POST_KERNEL_FAMILIES:
            family(name)
    # The cuda.* backends self-register on import via @harness.
    from repro_torch.kernels.spmv_ell import harness as _ell  # noqa: F401
    from repro_torch.kernels.bsr_spmm import harness as _bsr  # noqa: F401
    from repro_torch.kernels.moe_gmm import harness as _gmm  # noqa: F401
    for name in W.POST_KERNEL_FAMILIES:
        family(name)
    _builtins_done = True
    return H.REGISTRY
