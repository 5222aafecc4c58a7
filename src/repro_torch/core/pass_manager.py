"""The user-facing LiLAC pass (the paper's Fig. 1 compiler flow).

Counterpart of ``repro.core.pass_manager``.  ``compile(fn)`` returns a
callable that, per input signature, traces ``fn`` into an aten-level FX
graph, detects sparse computations in it and replaces them with harness
calls.  Two modes:

* ``mode="trace"`` (the default, as in the reference) selects among the
  jit-safe harnesses once per signature and builds the rewritten
  ``GraphModule`` (``rewrite.rewrite_graph``), the counterpart of the
  rewritten jaxpr under ``jax.jit``: every call runs that graph, and
  ``graph_for`` hands it to the caller to ``torch.compile`` or capture in
  a CUDA graph;
* ``mode="host"`` runs the traced graph eagerly with the anchors replaced
  by harness calls, the call's data plane amortizing format repacks across
  calls (paper Fig. 18); host-only harnesses (those that marshal) run
  only here.

Policies are ``"default"`` (the platform's default harness), an explicit
harness name, or ``"autotune"``: the persistent tuner
(:mod:`repro_torch.core.autotune`) measures the candidates for the call's
signature once, and the winner (harness, schedule, fusion) is pinned.

The compiled function runs on the card: ``platform="cuda"`` unless the
caller passes ``platform="cpu"`` (or ``device="cpu"``).  Asking for CUDA
where no card is present raises, and so do operands on another device —
the pass never falls back to the CPU quietly.  Not ported yet: executable
plans, the plan cache and fault containment; a harness that raises makes
the call raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import detect as D
from repro_torch.core import harness as H
from repro_torch.core.marshal import DataPlane, MarshalPolicy
from repro_torch.core.rewrite import needed_nodes, rewrite_graph, run_rewritten


@dataclasses.dataclass
class CompiledEntry:
    gm: Any                          # the traced, normalized FX graph
    report: D.DetectionReport
    tensor_pos: Tuple[int, ...]      # flat-argument positions of tensors
    out_spec: Any                    # pytree spec of the output
    needed: frozenset                # rewrite.needed_nodes of the report
    # autotune pins: match index -> (harness, schedule, fuse)
    pins: Dict[int, Tuple] = dataclasses.field(default_factory=dict)
    # trace mode: the rewritten graph and what was selected into it
    rewritten: Any = None
    selections: List[Tuple[D.Match, str]] = dataclasses.field(
        default_factory=list)
    schedules: List[Optional[Dict[str, Any]]] = dataclasses.field(
        default_factory=list)


def _leaf_key(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), x.device.type)
    return ("py", type(x).__name__, x)


def resolve_platform(platform: Optional[str], device=None) -> str:
    """'cuda' unless the caller asks for the CPU; CUDA without a card
    raises."""
    if device is not None:
        dev = torch.device(device).type
        if platform is not None and platform != dev:
            raise ValueError(f"platform={platform!r} disagrees with "
                             f"device={device!r}")
        platform = dev
    platform = platform or "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform must be 'cpu' or 'cuda', got {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass platform='cpu' "
                           "to run on the CPU")
    return platform


class LilacFunction:
    """A function passed through the LiLAC pass."""

    def __init__(self, fn: Callable, *, mode: str = "trace",
                 policy: str = "default", platform: Optional[str] = None,
                 device=None, marshal_policy=None):
        if mode not in ("trace", "host"):
            raise ValueError(f"mode must be 'trace' or 'host', got {mode!r}")
        self.fn = fn
        self.mode = mode
        self.policy = policy
        self.platform = resolve_platform(platform, device)
        self.marshal_policy = MarshalPolicy.parse(marshal_policy)
        # None: every call repacks (the paper's naive library call)
        self.cache = (DataPlane(self.marshal_policy)
                      if self.marshal_policy.enabled else None)
        self._compiled: Dict[Tuple, CompiledEntry] = {}
        # set-up paid per input signature: traces run and the seconds spent
        # tracing and detecting (repacks are the data plane's: cache.plans)
        self.stats = {"traces": 0, "trace_seconds": 0.0, "detect_seconds": 0.0}
        self.last_report: Optional[D.DetectionReport] = None
        # (match, harness-name) pairs from the most recent call, in anchor
        # order: what actually ran
        self.last_selections: List[Tuple[D.Match, str]] = []
        # the schedule each of those ran with (None: default or untuned)
        self.last_schedules: List[Optional[Dict[str, Any]]] = []

    # -- compilation ---------------------------------------------------------

    def _build_entry(self, leaves, spec) -> CompiledEntry:
        tensor_pos = tuple(i for i, x in enumerate(leaves)
                           if isinstance(x, torch.Tensor))
        out_spec = []

        def flat_fn(*tensors):
            vals = list(leaves)
            for i, t in zip(tensor_pos, tensors):
                vals[i] = t
            args, kwargs = tree_unflatten(vals, spec)
            out_leaves, s = tree_flatten(self.fn(*args, **kwargs))
            out_spec.append(s)
            return out_leaves

        t0 = time.perf_counter()
        gm = D.trace(flat_fn, [leaves[i] for i in tensor_pos])
        t1 = time.perf_counter()
        report = D.default_detector().detect(gm)
        self.stats["traces"] += 1
        self.stats["trace_seconds"] += t1 - t0
        self.stats["detect_seconds"] += time.perf_counter() - t1
        return CompiledEntry(gm, report, tensor_pos, out_spec[-1],
                             needed_nodes(gm, report.matches))

    def _entry_for(self, leaves, spec) -> CompiledEntry:
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.device.type != self.platform:
                raise ValueError(
                    f"compiled for {self.platform!r} but got a tensor on "
                    f"{x.device}")
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        entry = self._compiled.get(key)
        if entry is None:
            entry = self._compiled[key] = self._build_entry(leaves, spec)
        self.last_report = entry.report
        if self.mode == "trace" and entry.rewritten is None:
            self._build_graph(entry)
        return entry

    def _build_graph(self, entry: CompiledEntry) -> None:
        """Trace mode: select once per match and pin the winners into the
        rewritten graph."""
        selections: List[Tuple[D.Match, str]] = []
        schedules: List[Optional[Dict[str, Any]]] = []

        def on_select(m, h, ctx):
            selections.append((m, h.name))
            schedules.append(ctx.schedule)

        entry.rewritten = rewrite_graph(
            entry.gm, entry.report.matches, self._selector(entry),
            self._ctx_factory, on_select=on_select, needed=entry.needed)
        entry.selections, entry.schedules = selections, schedules

    def graph_for(self, *args, **kwargs) -> torch.fx.GraphModule:
        """Trace mode: the rewritten ``GraphModule`` for this signature,
        built on first use.  It takes the call's tensors, in the order
        ``torch.utils._pytree.tree_flatten((args, kwargs))`` gives them,
        and returns the flattened outputs: hand it to ``torch.compile`` or
        capture it in a ``torch.cuda.CUDAGraph``."""
        if self.mode != "trace":
            raise ValueError("graph_for needs mode='trace'; host mode runs "
                             "the traced graph eagerly with marshaling")
        leaves, spec = tree_flatten((args, kwargs))
        return self._entry_for(leaves, spec).rewritten

    # -- execution -----------------------------------------------------------

    def _select(self, m: D.Match, binding=None, ctx=None) -> H.Harness:
        return H.REGISTRY.select(m.computation, m.format, self.platform,
                                 self.mode, policy=self.policy,
                                 binding=binding, ctx=ctx)

    def _selector(self, entry: CompiledEntry):
        """The select function of a call: under ``policy='autotune'``,
        the tuner once per match per signature, then its pinned (harness,
        schedule, fuse); a fallback decision (nothing measurable) stays
        re-tunable on a later call."""
        if self.policy != "autotune":
            return self._select
        index = {m.anchor: i for i, m in enumerate(entry.report.matches)}

        def select(m, binding, ctx):
            i = index[m.anchor]
            pin = entry.pins.get(i)
            if pin is not None:
                name, ctx.schedule, ctx.fuse = pin
                return H.REGISTRY.get(m.computation, name)
            h = self._select(m, binding, ctx)
            dec = H.REGISTRY.autotuner.last_decision
            if dec is not None and dec.definitive:
                entry.pins[i] = dec.as_pin()
            return h

        return select

    def _ctx_factory(self, m: D.Match) -> H.CallCtx:
        return H.CallCtx(mode=self.mode, cache=self.cache, format=m.format,
                         platform=self.platform, epilogue=m.epilogue)

    def __call__(self, *args, **kwargs):
        leaves, spec = tree_flatten((args, kwargs))
        entry = self._entry_for(leaves, spec)
        tensors = [leaves[i] for i in entry.tensor_pos]
        if self.mode == "trace":
            outs = entry.rewritten(*tensors)
            self.last_selections = list(entry.selections)
            self.last_schedules = list(entry.schedules)
            return tree_unflatten(list(outs), entry.out_spec)
        selections: List[Tuple[D.Match, str]] = []
        schedules: List[Optional[Dict[str, Any]]] = []

        def on_select(m, h, ctx):
            selections.append((m, h.name))
            schedules.append(ctx.schedule)

        outs = run_rewritten(entry.gm, entry.report.matches,
                             self._selector(entry), tensors,
                             self._ctx_factory, on_select=on_select,
                             needed=entry.needed)
        self.last_selections = selections
        self.last_schedules = schedules
        return tree_unflatten(outs, entry.out_spec)


def compile(fn: Callable, *, mode: str = "trace", policy: str = "default",
            platform: Optional[str] = None, device=None,
            marshal_policy=None) -> LilacFunction:
    """The single LiLAC entry point: pass ``fn`` through the pass.

    ``mode``      'trace' (the default: the rewritten graph, jit-safe
                  harnesses only) or 'host' (eager with the data plane —
                  the paper's runtime model, where marshaling harnesses
                  run).
    ``policy``    'default' | 'autotune' | an explicit harness name.
    ``platform``  'cuda' (the default; raises without a card) or 'cpu'.
    ``device``    alternative spelling: its type picks the platform.
    ``marshal_policy``  a :class:`~repro_torch.core.marshal.MarshalPolicy`,
                  or 'shared' (default: one data plane per function) or
                  'off' (every call repacks); its ``reuse`` is the calls a
                  matrix over which the autotuner amortizes a repack.
    """
    return LilacFunction(fn, mode=mode, policy=policy, platform=platform,
                         device=device, marshal_policy=marshal_policy)
