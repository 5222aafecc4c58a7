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

A library that keeps state between calls (a handle, a workspace, a
layout of its own) declares it, as in the paper's Fig. 14::

    @lilac.hook("mylib_init")
    def mylib_init(state):
        state["layout"] = lilac.ReadObject(construct=mylib.pack,
                                           update=mylib.repack,
                                           destruct=mylib.free)

    @lilac.harness('''
    HARNESS mylib.spmv implements spmv_csr
      host_only;
      persistent layout;
      BeforeFirstExecution mylib_init;
      AfterLastExecution mylib_fini;
    ''', hooks={"mylib_fini": lambda state: state["layout"].release()})
    def mylib_spmv(binding, ctx):
        ...   # reads the harness's persistent["layout"]

``lilac.compile(f, enabled=False)`` returns ``f``'s own answers (the A/B
baseline); ``lilac.compile(f, options=lilac.CompileOptions(...))`` and
``@lilac.compile(mode="host")`` are the other spellings.

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
                                      ReadObject, SparseFormat, TrackedArray,
                                      edge, register_format, register_source)
from repro_torch.core.pass_manager import (CompileOptions, LilacFunction,
                                           compile)
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
from repro_torch.core.spec import (HOOKS, REPACKS, VJPS, SpecError,
                                   build_harnesses, harness, hook,
                                   register_builtins, register_spec, repack,
                                   vjp)
from repro_torch.core.what_lang import (BUILTIN_SPECS, BUILTINS, Computation,
                                        Constraint, HarnessDecl, MarshalClause,
                                        ParseError, Spec, TuneClause,
                                        enumerate_schedules, parse,
                                        parse_harness, parse_spec)

__all__ = [
    # entry point
    "compile", "CompileOptions", "LilacFunction",
    # spec surface
    "harness", "repack", "hook", "vjp", "register_spec", "register_builtins",
    "build_harnesses", "SpecError", "REPACKS", "HOOKS", "VJPS",
    # language
    "parse", "parse_spec", "parse_harness", "ParseError", "Spec",
    "Computation", "HarnessDecl", "MarshalClause", "TuneClause",
    "Constraint", "enumerate_schedules", "BUILTINS", "BUILTIN_SPECS",
    # epilogues
    "apply_epilogue",
    # registry / runtime
    "REGISTRY", "Harness", "HarnessRegistry", "DuplicateHarnessError",
    "CallCtx", "MarshalingCache", "ReadObject", "Autotuner",
    "AutotuneCache",
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
