"""LiLAC spec compilation: How-descriptors -> executable harnesses (§3.3).

Counterpart of ``repro.core.spec``.  A library implementer writes a
HARNESS block and a kernel body; this module does the rest:

* ``build_harnesses`` turns a parsed ``HarnessDecl`` plus a body into
  registered :class:`~repro_torch.core.harness.Harness` objects.  The
  marshaling wrapper is *generated* from the declared ``marshal`` clauses,
  which route each repack through the call's data plane.
* ``@harness(...)`` is the decorator form (see
  ``repro_torch/kernels/*/harness.py``).
* ``@repack(name)`` registers the format conversions spec texts name.
* ``register_builtins`` populates the registry from the builtin spec
  texts plus the HARNESS blocks next to the CUDA kernels.

Not ported yet: persistence hooks (BeforeFirstExecution /
AfterLastExecution / persistent), ``vjp`` backward bodies and ``tune``
schedule spaces (there is no autotuner); a HARNESS block that declares one
is refused.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.core import harness as H
from repro_torch.core import marshal as M
from repro_torch.core import what_lang as W


class SpecError(ValueError):
    """A spec references something the How-compiler cannot resolve."""


REPACKS: Dict[str, Callable[[H.Binding], Any]] = {}


def repack(name: str, *, override: bool = False):
    """Register a marshaling repack function ``binding -> packed value``
    under ``name`` so ``marshal x = name(...)`` clauses can refer to it."""
    def deco(fn):
        if name in REPACKS and REPACKS[name] is not fn and not override:
            raise SpecError(f"repack {name!r} is already registered")
        REPACKS[name] = fn
        return fn
    return deco


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
    inputs arrive at the kernel body as keyword arguments.  A clause with
    ``from <src> to <dst>`` goes through the data plane's conversion graph,
    with the clause's repack as the fallback."""
    clauses = decl.marshal

    def fn(binding: H.Binding, ctx: H.CallCtx):
        marshaled = {}
        for cl in clauses:
            pack = REPACKS[cl.repack]
            keys = tuple(_resolve_key(binding, alts) for alts in cl.keys)
            if cl.src and cl.dst:
                marshaled[cl.name] = ctx.cache.ensure(
                    cl.src, cl.dst, keys, binding,
                    fallback=lambda p=pack: p(binding))
            else:
                marshaled[cl.name] = ctx.cache.get(
                    cl.repack, keys, lambda p=pack: p(binding))
        return body(binding, ctx, **marshaled)

    fn.__name__ = getattr(body, "__name__", decl.name)
    fn.__qualname__ = getattr(body, "__qualname__", decl.name)
    return fn


def build_harnesses(decl: W.HarnessDecl, body: Callable) -> List[H.Harness]:
    """Compile one HARNESS descriptor + kernel body into Harness objects
    (one per implemented computation)."""
    if decl.before_first or decl.after_last or decl.persistent:
        raise SpecError(f"harness {decl.name!r}: persistence hooks are not "
                        f"supported by this package yet")
    if decl.vjp is not None:
        raise SpecError(f"harness {decl.name!r}: vjp clauses are not "
                        f"supported by this package yet")
    if decl.tune or decl.constraints:
        raise SpecError(f"harness {decl.name!r}: tune clauses are not "
                        f"supported by this package yet (no autotuner)")
    fn = _marshaled_fn(decl, body) if decl.marshal else body
    return [
        H.Harness(decl.name, comp, fn, jit_safe=decl.jit_safe,
                  platforms=decl.platforms, formats=decl.formats,
                  marshal=decl.marshal, fuse_epilogue=decl.fuse_epilogue)
        for comp in decl.implements
    ]


def register_spec(spec: Union[str, W.Spec], bodies: Dict[str, Callable], *,
                  registry: Optional[H.HarnessRegistry] = None,
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
        hs = build_harnesses(decl, body)
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
    return registered


def harness(decl: Union[str, W.HarnessDecl], *,
            registry: Optional[H.HarnessRegistry] = None,
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
        register_spec(spec, {name: body}, registry=registry,
                      override=override)
        return body

    return deco


# ---------------------------------------------------------------------------
# The builtin data plane: the source loader (binding -> CSR) and the
# conversion edges the SpMV harnesses name; the repack functions below are
# the single-hop fallbacks.
# ---------------------------------------------------------------------------

M.register_source("csr_binding", "CSR", H._binding_to_csr)


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


@repack("ell_pack")
def _ell_pack(b: H.Binding):
    return _csr_to_ell8(H._binding_to_csr(b))


@repack("ell_pack128")
def _ell_pack128(b: H.Binding):
    return _csr_to_ell128(H._binding_to_csr(b))


@repack("densify")
def _densify(b: H.Binding):
    return H._binding_to_csr(b).todense()


# ---------------------------------------------------------------------------
# Builtin registration
# ---------------------------------------------------------------------------

_builtins_done = False


def register_builtins() -> H.HarnessRegistry:
    """Populate the global REGISTRY from the builtin spec texts (the
    HARNESS blocks that have a body in ``harness.BUILTIN_BODIES``), then
    the CUDA kernels' own HARNESS blocks."""
    global _builtins_done
    if _builtins_done:
        return H.REGISTRY
    for family, bodies in H.BUILTIN_BODIES.items():
        spec = W.parse_spec(W.BUILTIN_SPECS[family])
        spec = W.Spec(spec.computations,
                      tuple(h for h in spec.harnesses if h.name in bodies))
        register_spec(spec, bodies, override=True)
    # The cuda.* backends self-register on import via @harness.
    from repro_torch.kernels.spmv_ell import harness as _ell  # noqa: F401
    _builtins_done = True
    return H.REGISTRY
