"""repro_torch.lilac — the LiLAC declarative spec API, in one namespace.

Counterpart of ``repro.lilac`` for the names this package has.
Application authors::

    from repro_torch import lilac

    fast = lilac.compile(step)          # trace mode: a rewritten graph
    fast(val, col, row_ptr, vec)        # detected, rewritten, on the card
    fast.graph_for(val, col, row_ptr, vec)   # the graph, to compile/capture
    host = lilac.compile(step, mode="host", policy="autotune")
    host(val, col, row_ptr, vec); host(val, col, row_ptr, vec)
    host.plan_info()                    # baked: 1, plan_hits: 1
    host.resilience_info()              # containment, quarantine, shadows

Library implementers (spec + function = a new backend)::

    @lilac.harness('''
    HARNESS mylib.spmv implements spmv_csr
      formats CSR;
      host_only;
      marshal packed = my_pack(a, colidx, rowstr|rowidx);
    ''')
    def mylib_spmv(binding, ctx, *, packed):
        return mylib.spmv(packed, binding["iv"])

A ``vjp spmv_csr_bwd(a, iv);`` clause in that block makes the harness
differentiable: its calls then run inside one ``torch.autograd.Function``
whose backward is the named body (``@lilac.vjp(name)`` registers one), so
``.backward()`` and ``torch.func.grad`` reach ``a`` and ``iv``.
"""
from repro_torch.core import faults
from repro_torch.core.autotune import Autotuner, AutotuneCache
from repro_torch.core.harness import (REGISTRY, CallCtx, DuplicateHarnessError,
                                      Harness, HarnessRegistry)
from repro_torch.core.marshal import (FORMATS, GRAPH, SOURCES, ConversionEdge,
                                      ConversionGraph, DataPlane,
                                      MarshalingCache, MarshalPolicy,
                                      SparseFormat, TrackedArray, edge,
                                      register_format, register_source)
from repro_torch.core.pass_manager import LilacFunction, compile
from repro_torch.core.plan import ExecutablePlan, PlanCache
from repro_torch.core.resilience import (Containment, ContainmentStats,
                                         LilacContainmentWarning,
                                         QuarantineStore, ReferenceFallback,
                                         StickyDeviceFault,
                                         default_quarantine_path,
                                         outputs_close,
                                         reset_shared_quarantine,
                                         shared_quarantine)
from repro_torch.core.rewrite import apply_epilogue
from repro_torch.core.spec import (REPACKS, VJPS, SpecError, build_harnesses,
                                   harness, register_builtins, register_spec,
                                   repack, vjp)
from repro_torch.core.what_lang import (BUILTIN_SPECS, BUILTINS, Computation,
                                        Constraint, HarnessDecl, MarshalClause,
                                        ParseError, Spec, TuneClause,
                                        enumerate_schedules, parse,
                                        parse_harness, parse_spec)

__all__ = [
    # entry point
    "compile", "LilacFunction",
    # spec surface
    "harness", "repack", "vjp", "register_spec", "register_builtins",
    "build_harnesses", "SpecError", "REPACKS", "VJPS",
    # language
    "parse", "parse_spec", "parse_harness", "ParseError", "Spec",
    "Computation", "HarnessDecl", "MarshalClause", "TuneClause",
    "Constraint", "enumerate_schedules", "BUILTINS", "BUILTIN_SPECS",
    # epilogues
    "apply_epilogue",
    # registry / runtime
    "REGISTRY", "Harness", "HarnessRegistry", "DuplicateHarnessError",
    "CallCtx", "MarshalingCache", "Autotuner", "AutotuneCache",
    # executable plans
    "ExecutablePlan", "PlanCache", "TrackedArray",
    # data plane
    "DataPlane", "MarshalPolicy", "SparseFormat", "ConversionEdge",
    "ConversionGraph", "FORMATS", "GRAPH", "SOURCES", "edge",
    "register_format", "register_source",
    # containment (fault injection, quarantine, contained retry, shadows)
    "faults", "Containment", "ContainmentStats", "QuarantineStore",
    "ReferenceFallback", "LilacContainmentWarning", "StickyDeviceFault",
    "default_quarantine_path", "outputs_close", "shared_quarantine",
    "reset_shared_quarantine",
]
