"""repro_torch.core — the LiLAC pass on FX graphs (trace and host modes).

Public API (prefer the ``repro_torch.lilac`` facade):
    compile / CompileOptions   the single LiLAC entry point
    spec                       HARNESS-descriptor compiler + @harness
    Detector                   backtracking FX-graph detection
    REGISTRY / Harness         LiLAC-How backends (populated from specs)
    DataPlane                  fingerprint-keyed marshaling cache
    ReadObject / hook          a harness's persistent state (Fig. 14)
    TrackedArray               explicit-version operand wrapper
    ExecutablePlan / PlanCache baked dispatch and its persistent store
    faults / resilience        fault injection, quarantine, contained retry,
                               shadow checks
    autotune                   persistent, signature-keyed harness tuning
    what_lang                  the LiLAC spec language (Fig. 3 + §3.3)
"""
from repro_torch.core.detect import (DetectionReport, Detector, Match,
                                     default_detector)
from repro_torch.core.harness import (REGISTRY, CallCtx, DuplicateHarnessError,
                                      Harness, HarnessRegistry)
from repro_torch.core.marshal import (FORMATS, GRAPH, SOURCES, ConversionEdge,
                                      ConversionGraph, DataPlane,
                                      MarshalingCache,
                                      MarshalPolicy, ReadObject,
                                      SparseFormat, TrackedArray,
                                      fingerprint, version_token)
from repro_torch.core.pass_manager import (CompileOptions, LilacFunction,
                                           compile)
from repro_torch.core.plan import ExecutablePlan, PlanBakeError, PlanCache
from repro_torch.core.resilience import (Containment, ContainmentStats,
                                         LilacContainmentWarning,
                                         QuarantineStore, ReferenceFallback,
                                         StickyDeviceFault,
                                         default_quarantine_path,
                                         outputs_close,
                                         reset_shared_quarantine,
                                         shared_quarantine)
from repro_torch.core import faults
from repro_torch.core import autotune
from repro_torch.core import spec
from repro_torch.core import what_lang
from repro_torch.core.spec import HOOKS, hook

# Populate REGISTRY from the builtin spec texts (torch.* families) and the
# HARNESS blocks declared next to the CUDA kernels.
spec.register_builtins()

__all__ = [
    "Detector", "DetectionReport", "Match", "default_detector",
    "REGISTRY", "CallCtx", "DuplicateHarnessError", "Harness",
    "HarnessRegistry",
    "MarshalingCache", "DataPlane", "MarshalPolicy", "SparseFormat",
    "ConversionEdge", "ConversionGraph", "FORMATS", "GRAPH", "SOURCES",
    "fingerprint", "ReadObject", "LilacFunction", "compile",
    "CompileOptions", "spec", "autotune",
    "what_lang", "TrackedArray", "version_token", "ExecutablePlan",
    "PlanBakeError", "PlanCache",
    "faults", "Containment", "ContainmentStats", "QuarantineStore",
    "ReferenceFallback", "LilacContainmentWarning", "StickyDeviceFault",
    "default_quarantine_path", "outputs_close", "shared_quarantine",
    "reset_shared_quarantine", "hook", "HOOKS",
]
