"""The user-facing LiLAC pass (the paper's Fig. 1 compiler flow).

Counterpart of ``repro.core.pass_manager``.  ``compile(fn)`` returns a
callable that, per input signature, traces ``fn`` into an aten-level FX
graph, detects sparse computations in it and replaces them with harness
calls.  Two modes:

* ``mode="trace"`` (the default, as in the reference) selects among the
  jit-safe harnesses once per signature and builds the rewritten
  ``GraphModule`` (``rewrite.rewrite_graph``), the counterpart of the
  rewritten jaxpr under ``jax.jit``; ``graph_for`` hands it to the caller
  to ``torch.compile`` or capture in a CUDA graph;
* ``mode="host"`` runs the traced graph with the anchors replaced by
  harness calls, the call's data plane amortizing format repacks across
  calls (paper Fig. 18); host-only harnesses (those that marshal) run
  only here.

Policies are ``"default"`` (the platform's default harness), an explicit
harness name, or ``"autotune"``: the persistent tuner
(:mod:`repro_torch.core.autotune`) measures the candidates for the call's
signature once, and the winner (harness, schedule, fusion) is pinned; once
every match of a program is pinned, the joint search
(:mod:`repro_torch.core.plan_search`) re-costs the measured candidates
together, with zero re-timing, and may move the pins.

**Plans** (:mod:`repro_torch.core.plan`).  Once every selection is
definitive and a call has run, the entry is baked into an
:class:`~repro_torch.core.plan.ExecutablePlan` (``bake=True``, the
default): the marshaled buffers hoisted, and on the card the program in
one CUDA graph.  A later call whose guards hold replays it: the last plan
first, then a short list of recently served plans (bucketed callers rotate
between a few signatures), then the entry's own.  A guard miss runs the
interpreter, which either finds that the data plane served the same
buffers (a re-upload of the same bytes, which the data plane confirms by
checksum: the plan's guards move to the new tensors, no re-bake) or
re-bakes; after four re-bakes of plans that never
served a call the entry stops baking.  Marshal-bearing selections never
bake under ``marshal_policy="off"`` (it promises a repack every call), nor
does a harness that opts out (``bakeable=False``).  The persistent plan
cache keys the traced graph: a warm process rehydrates the matches and the
pins from ``plans.json``, so it runs no detection and times nothing.

**Transforms** (docs/transforms.md).  Grad-of-compile: a call whose
tensors require grad (``.backward()``, or inside ``torch.func.grad``) keys
an entry of its own and runs the interpreter (host mode) or its own
rewritten graph (trace mode) with autograd through every harness
(``rewrite.call_harness``: epilogues unfused, ``vjp`` clauses as
``torch.autograd.Function``s, each custom op through its differentiable
call, ``kernels.common.differentiable``, which runs under a ``torch.func``
grad level as under ``.backward()``).  Compile-of-grad:
``compile(torch.func.grad(f))`` traces to a plain graph holding the
backward too, so the backward's sparse products (the SpMVᵀ, a COO SpMV of
the matrix's entries) are detected like any other and the entry bakes.
A compiled function called while another trace runs (``make_fx``, a
compiled step) traces, detects and selects on its own, outside the
ambient modes (``detect.own_trace``), and its custom ops trace into the
outer graph with their formulas (next paragraph but one).  Vmap-of-compile:
``torch.func.vmap(compile(f))`` traces ``f`` on the per-element shapes (a
batched tensor hides its batch axis), so detection fires on the
per-element program, and an unplanned call runs that program on the
batched tensors: trace mode its rewritten graph, each custom op once for
the batch through its ``register_vmap`` rule (K1, K2 and K4 as one
launch, K3 with the vectors as columns), host mode the interpreter, each
harness once on the batched binding.  A harness with a marshal clause
whose marshal source (the matrix) is batched runs once an element
(``levels.per_element``: a repack and a launch each).  Such a call keys
an entry of its own (``levels.grad_state``).

**Plans under transforms** (:mod:`repro_torch.core.plan`, "Plans under
transforms").  A vmapped call, a gradient-carrying call and a call under
``torch.func.grad`` each bake a plan on their entry's first resolved call
and are served by it after: a guard check and one replay (a batched
program of one launch a custom op; eager where gradients flow), with no
detection, fingerprint or selection.  What stays refused is stated in
``bake_errors``: a batched marshal source, a marshal source that requires
grad, a ``scan_body`` entry.  The validator reads a batched output (a
sync) until a call of the entry runs clean; later calls, planned or not,
are checked as plan calls are, by the sampled shadow check against the
uncompiled function (``_maybe_shadow_batched``), which counts each element
and runs the uncompiled function once an element of the outermost
``vmap`` level.

**Inside a user's trace** (docs/transforms.md, the user ``jax.jit`` row;
:mod:`repro_torch.core.plan`, "Plans under a user's trace").  Dynamo
never traces this object's Python (:func:`_dynamo_entry`): in trace mode
the call is one opaque node of the caller's graph, which AOT autograd's
trace runs on its fake tensors, so the entry's program and its custom-op
nodes land in the caller's graph (``torch.compile(step, fullgraph=True)``
launches K1 or K4 from its compiled program); in host mode dynamo stops
at the call (a graph break), which then runs concretely through its plan.
A call traced into another graph (``make_fx``, AOT's trace; ``traced``
in :meth:`LilacFunction._call`) detects and selects once a signature,
bakes under the trace with its CUDA-graph capture deferred to the first
concrete call, and is served into later traces by its plan's program
(``plan_info()["trace_serves"]``).  A host-mode match whose harness does
host-side work runs as the plain program in such a call on the CPU, and
raises on the card (:func:`_concrete_only`); no plan that hoists a
marshaled layout serves a trace.  A symbolic size (a dynamic dim of a
``torch.compile``'d caller) is specialized to the call's, so each size
is a signature of its own.  What a harness does inside the caller's
compiled program is out of containment's reach: no validator, shadow
check, quarantine or plan guard runs there.

**Scans** (docs/transforms.md, "scan: detect once, reuse every
iteration").  A torch scan whose body holds a match is one ``scan_body``
match: its body is detected once per signature, and the loop runs around
the rewritten body (``rewrite.run_rewritten``).  Pins, selections,
disabled matches, the tuner and the joint search number the inner matches
with the others (``CompiledEntry.flat``).  A scan drops as a whole when
containment disables an inner match, so it then runs plain.  Such an
entry never bakes (``plan_info()["bake_errors"]`` says why) and never
persists a plan-cache record: it stays in this process's memory.

The compiled function runs on the card: ``platform="cuda"`` unless the
caller passes ``platform="cpu"`` (or ``device="cpu"``).  Asking for CUDA
where no card is present raises, and so do operands on another device —
the pass never falls back to the CPU quietly.

**Containment** (:mod:`repro_torch.core.resilience`).  Every anchor of an
interpreted call, and every anchor traced into a trace-mode graph, runs
under a :class:`~repro_torch.core.resilience.Containment`: a harness that
raises, returns the wrong size or (on a concrete call) non-finite values
is quarantined, loudly (``LilacContainmentWarning``), and the anchor
retries with the next candidate; when none is left the match is disabled
and its anchor runs as the plain graph node, so the call returns the
uncompiled program's answer.  The retry loop is bounded by the match
count + 1.  On the card a hand-written kernel's (``cuda.*``) own
exception is not contained: it reaches the caller.  A quarantine unwinds
the entry's pin, plan, persisted plan record and joint result, and no
layer restores a quarantined harness: selection under every policy (each
skip warns and counts ``quarantine_skips``), the tuner, the joint search,
rehydrated pins.  A CUDA error that poisons the context is recorded and raised
(:class:`~repro_torch.core.resilience.StickyDeviceFault`).  Plan calls
are not validated (no sync on that path); ``LILAC_TORCH_SHADOW_RATE``
samples them against the uncompiled program instead, and a divergence
serves the uncompiled answer, quarantines the plan's selections and
tears the plan down.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import detect as D
from repro_torch.core import faults
from repro_torch.core import harness as H
from repro_torch.core import levels
from repro_torch.core import plan as P
from repro_torch.core import plan_search as PS
from repro_torch.core import resilience as R
from repro_torch.core.autotune import autotune_disabled, variant_key
from repro_torch.core.marshal import DataPlane, MarshalPolicy, unwrap
from repro_torch.core.rewrite import needed_nodes, rewrite_graph, run_rewritten
from repro_torch.kernels.common import differentiable_graph


@dataclasses.dataclass
class CompiledEntry:
    gm: Any                          # the traced, normalized FX graph
    report: D.DetectionReport
    tensor_pos: Tuple[int, ...]      # flat-argument positions of tensors
    out_spec: Any                    # pytree spec of the output
    # autotune pins: match index -> (harness, schedule, fuse); after the
    # joint search, the jointly optimal assignment
    pins: Dict[int, Tuple] = dataclasses.field(default_factory=dict)
    # trace mode: the rewritten graph and what was selected into it, and
    # the graph a call runs (for calls that carry gradients, the rewritten
    # graph with the custom ops' differentiable calls)
    rewritten: Any = None
    runs: Any = None
    selections: List[Tuple[D.Match, str]] = dataclasses.field(
        default_factory=list)
    schedules: List[Optional[Dict[str, Any]]] = dataclasses.field(
        default_factory=list)
    fuses: List[Optional[bool]] = dataclasses.field(default_factory=list)
    # the persistent plan cache's key and whether this entry is stored
    cache_key: Optional[str] = None
    persisted: bool = False
    # the baked plan (None until the entry is resolved and a call ran)
    plan: Optional[P.ExecutablePlan] = None
    no_bake: bool = False
    bake_error: Optional[str] = None
    rebakes: int = 0
    # the joint search's report, and whether it ran (or was skipped); an
    # entry rehydrated with complete pins starts done: its pins are the
    # joint assignment of the process that searched
    joint: Optional[Dict[str, Any]] = None
    joint_done: bool = False
    # indices into flat() of the matches whose every candidate failed
    # under containment: their anchors run as plain graph nodes until the
    # entry is rebuilt, and a scan holding one runs plain as a whole
    disabled: set = dataclasses.field(default_factory=set)
    # per tensor leaf, whether it requires grad: such an entry carries
    # gradients (epilogues unfused; its plan runs eagerly)
    grad_inputs: Tuple[bool, ...] = ()
    # a leaf carries a vmap level: the calls run batched
    batched: bool = False
    # a batched entry's call ran clean under the validator: later calls
    # are not validated (no sync), the shadow check samples them as it
    # samples plan calls; a quarantine or divergence clears it
    validated: bool = False
    # rewrite.needed_nodes per set of matches evaluated (containment can
    # disable single matches)
    _needed: Dict[FrozenSet[int], frozenset] = dataclasses.field(
        default_factory=dict)

    def needed_for(self, matches) -> frozenset:
        key = frozenset(id(m.anchor) for m in matches)
        got = self._needed.get(key)
        if got is None:
            got = self._needed[key] = needed_nodes(self.gm, matches)
        return got

    def flat(self) -> List[D.Match]:
        """The matches that select a harness: the report's, each
        ``scan_body`` wrapper replaced by its inner matches
        (``detect.flat_matches``).  Pins, disabled matches and selections
        are numbered in this order."""
        return D.flat_matches(self.report.matches)

    def enabled(self) -> List[D.Match]:
        """The report's matches minus the disabled ones.  A ``scan_body``
        wrapper drops as a whole when any of its inner matches is
        disabled: no iteration mixes harnesses and the plain body."""
        if not self.disabled:
            return self.report.matches
        off = {id(m) for i, m in enumerate(self.flat()) if i in self.disabled}
        return [m for m in self.report.matches
                if not any(id(f) in off for f in D.flat_matches([m]))]

    def index_of(self, m: D.Match) -> Optional[int]:
        for i, mm in enumerate(self.flat()):
            if mm is m:
                return i
        return None

    def has_scan(self) -> bool:
        return any(m.body is not None for m in self.report.matches)


def _leaf_key(x) -> Tuple:
    """The compile-dict key of one leaf (``plan.leaf_templates``' rule)."""
    (t,) = P.leaf_templates([x])
    if t[0] == "t":
        return ("t", t[1], str(t[2]), t[3].type, t[4])
    return ("py", t[1].__name__, t[2])


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

    _HOT_PLAN_LIMIT = 32
    _REBAKE_LIMIT = 4

    def __init__(self, fn: Callable, *, mode: str = "trace",
                 policy: str = "default", platform: Optional[str] = None,
                 device=None, marshal_policy=None, bake: bool = True,
                 plan_cache: Any = None, enabled: bool = True,
                 registry: Optional[H.HarnessRegistry] = None,
                 detector: Optional[D.Detector] = None,
                 cache: Optional[DataPlane] = None):
        if mode not in ("trace", "host"):
            raise ValueError(f"mode must be 'trace' or 'host', got {mode!r}")
        self.fn = fn
        self.mode = mode
        self.policy = policy
        # False: every call runs ``fn`` itself (the A/B baseline)
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else H.REGISTRY
        # None: the default detector, rebuilt when a spec adds a computation
        self.detector = detector
        self.platform = resolve_platform(platform, device)
        self.marshal_policy = MarshalPolicy.parse(marshal_policy)
        # a data plane the caller shares between functions, else this
        # function's own; None: every call repacks (the paper's naive
        # library call)
        if cache is not None:
            self.cache = cache
        else:
            self.cache = (DataPlane(self.marshal_policy)
                          if self.marshal_policy.enabled else None)
        self.bake_enabled = bool(bake)
        self._plan_cache_injected = isinstance(plan_cache, P.PlanCache)
        # the persistent plan cache keys a graph's default detection: a
        # function with a detector of its own neither reads nor writes it
        if detector is not None and plan_cache not in (
                None, False, True, "default", "on", "off", "none", "disabled"):
            raise ValueError(
                "a function compiled with its own detector keeps no "
                "persistent plan records: pass plan_cache= or detector=, "
                "not both")
        self._plan_cache = (None if detector is not None
                            else self._make_plan_cache(plan_cache))
        self._compiled: Dict[Tuple, CompiledEntry] = {}
        self._last_compiled: Optional[Tuple] = None   # (entry, spec, tmpl)
        self._last_plan: Optional[P.ExecutablePlan] = None
        # recently served plans across signatures, most recent first
        self._hot_plans: List[P.ExecutablePlan] = []
        # flat leaf positions a bake captures onto static buffers from the
        # start: prewarm's throwaway inputs, which no later call brings again
        self._static_leaves: frozenset = frozenset()
        # set-up paid per input signature: traces run and the seconds spent
        # tracing and detecting (repacks are the data plane's: cache.plans)
        self.stats = {"traces": 0, "trace_seconds": 0.0, "detect_seconds": 0.0,
                      "detects": 0}
        self.last_report: Optional[D.DetectionReport] = None
        # (match, harness-name) pairs from the most recent call, in anchor
        # order: what actually ran
        self.last_selections: List[Tuple[D.Match, str]] = []
        # the schedule each of those ran with (None: default or untuned)
        self.last_schedules: List[Optional[Dict[str, Any]]] = []
        # containment: this function's counters, the adaptive shadow rate
        # (the environment's rate is a floor; incidents spike it, clean
        # checks decay it) and the guard that keeps a shadow's own call
        # from shadowing
        self.resilience_stats = R.ContainmentStats()
        self._shadow = R.AdaptiveShadowRate(R.ENV_SHADOW)
        self._shadow_ctr = 0
        self._in_shadow = False
        # calls traced into another graph that no plan served (a plan's
        # serves are its ``trace_serves``), by what they traced: the
        # rewritten graph (trace mode), the interpreter (host); and the
        # anchors such calls ran as the plain program on the CPU, their
        # harness's host-side work (a marshal clause, a lifecycle hook)
        # having no concrete matrix to read
        self.traced_calls = {"rewritten_graph": 0, "interpreter": 0,
                             "plain_anchors": 0}
        # harness outputs containment could check for size only: traced
        # values (the rewritten graph's own trace, or a traced call's)
        self.unread_traced = 0
        # what dynamo meets when a torch.compile'd caller reaches this
        # function (it never traces this object's own Python)
        self._dynamo_call = _dynamo_entry(self)

    def _make_plan_cache(self, opt) -> Optional[P.PlanCache]:
        if opt is False or opt in ("off", "none", "disabled"):
            return None
        if isinstance(opt, P.PlanCache):
            return opt
        fp = self.registry.fingerprint()
        if opt in (None, True, "default", "on"):
            # only the default location honors the environment's switch: a
            # path the caller names is the stronger statement
            return None if P.plan_cache_disabled() \
                else P.shared_plan_cache(None, fp)
        return P.shared_plan_cache(opt, fp)

    # -- compilation ---------------------------------------------------------

    def _validated_pins(self, raw: Dict[str, Any], matches) -> Dict[int, Tuple]:
        """Pins rehydrated from the plan cache, checked against the live
        registry: a vanished harness, a schedule outside its harness's
        current tune space or a quarantined (harness, variant) drops the
        pin (the tuner re-tunes it)."""
        pins: Dict[int, Tuple] = {}
        q = R.shared_quarantine()
        for k, v in (raw or {}).items():
            try:
                i, name, schedule, fuse = int(k), v[0], v[1], v[2]
            except (TypeError, ValueError, IndexError):
                continue
            if not 0 <= i < len(matches):
                continue
            try:
                h = self.registry.get(matches[i].computation, name)
            except KeyError:
                continue
            if schedule is not None and schedule not in h.schedules:
                continue
            # the record predates any incident that quarantined it
            if R.quarantined(q, matches[i].computation, name,
                             variant_key(schedule, fuse)):
                continue
            pins[i] = (name, schedule, fuse)
        return pins

    def _plan_cache_view(self) -> Optional[P.PlanCache]:
        pc = self._plan_cache
        if pc is not None and not self._plan_cache_injected \
                and pc.registry_fingerprint != self.registry.fingerprint():
            # harnesses registered since: re-key the view, so stale plans
            # invalidate and fresh ones persist
            pc = self._plan_cache = P.shared_plan_cache(
                pc.path, self.registry.fingerprint())
        return pc

    def _rehydrate(self, pc: P.PlanCache, gm, key: str):
        """(report, pins, joint) from a plan-cache record, or None."""
        rec = pc.get(key)
        if rec is None:
            return None
        ser = rec.get("matches", ())
        got = None
        # integrity first: n_eqns and the digest must agree with the live
        # graph and the record's own matches before any node is resolved
        if (rec.get("n_eqns") == P.n_ops(gm)
                and rec.get("detect_digest") == P.detect_digest(ser)):
            got = P.rehydrate_matches(gm, ser)
        if got is None:
            pc.stats.rejected += 1
            return None
        report = D.DetectionReport(
            got, n_eqns=P.n_ops(gm),
            log=["rehydrated from plan cache (detection + tuning skipped)"])
        return report, self._validated_pins(rec.get("pins"), got), \
            rec.get("joint")

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
        self.stats["traces"] += 1
        self.stats["trace_seconds"] += t1 - t0
        pc = self._plan_cache_view()
        key = served = None
        if pc is not None:
            key = P.plan_key(gm, self.platform, self.mode, self.policy,
                             reuse=self.marshal_policy.reuse)
            served = self._rehydrate(pc, gm, key)
        if served is not None:
            report, pins, joint = served
        else:
            detector = self.detector or D.default_detector()
            report, pins, joint = detector.detect(gm), {}, None
            self.stats["detects"] += 1
        self.stats["detect_seconds"] += time.perf_counter() - t1
        entry = CompiledEntry(gm, report, tensor_pos, out_spec[-1],
                              pins=pins, cache_key=key,
                              grad_inputs=tuple(levels.requires_grad(leaves[i])
                                                for i in tensor_pos),
                              batched=any(levels.batched(leaves[i])
                                          for i in tensor_pos))
        self._reset_bake(entry)
        complete = len(pins) == len(entry.flat())
        # a served record with complete pins never re-persists; one whose
        # pins were dropped re-persists once this process resolves them
        entry.persisted = served is not None and (
            self.policy != "autotune" or complete)
        if served is not None and pins and complete:
            entry.joint_done, entry.joint = True, joint
        return entry

    def _reset_bake(self, entry: CompiledEntry) -> None:
        """Clear the entry's refusal to bake, except the standing one of an
        entry that holds a ``scan_body`` rewrite.  (A batched marshal
        source and one that requires grad are refused at the bake, where
        the selected harnesses name the marshal sources.)"""
        runs = "rewritten graph" if self.mode == "trace" else "interpreter"
        entry.bake_error = None
        if entry.has_scan():
            entry.bake_error = (
                f"scan-body rewrite: every call runs the {runs}, whose loop "
                f"reuses the body's harnesses at each step; a plan's guards "
                f"cannot cover the marshal sources inside the body")
        entry.no_bake = entry.bake_error is not None

    @staticmethod
    def _unwrap(flat) -> List[Any]:
        """The leaves with TrackedArray operands unwrapped."""
        return [unwrap(x) for x in flat]

    def _entry_for(self, leaves, spec, traced: bool = False) -> CompiledEntry:
        """The entry of this signature, its rewritten graph built (trace
        mode); ``traced``: the call is traced into another graph, so the
        selection (the tuner's measurements included) runs outside the
        ambient modes."""
        entry = self._lookup(leaves, spec)
        if self.mode == "trace" and entry.rewritten is None:
            with D.own_trace() if traced else contextlib.nullcontext():
                self._build_graph(entry)
        return entry

    def _lookup(self, leaves, spec) -> CompiledEntry:
        """The entry of this signature (traced and detected on first use,
        or rehydrated from the plan cache); selects nothing."""
        last = self._last_compiled
        if last is not None and last[1] == spec \
                and P.leaves_match(last[2], leaves):
            entry = last[0]
        else:
            for x in leaves:
                if isinstance(x, torch.Tensor) \
                        and x.device.type != self.platform:
                    raise ValueError(
                        f"compiled for {self.platform!r} but got a tensor on "
                        f"{x.device}")
            key = (spec, tuple(_leaf_key(x) for x in leaves))
            entry = self._compiled.get(key)
            if entry is None:
                entry = self._compiled[key] = self._build_entry(leaves, spec)
            self._last_compiled = (entry, spec, P.leaf_templates(leaves))
        self.last_report = entry.report
        return entry

    def report_for(self, *args, **kwargs) -> D.DetectionReport:
        """The detection report of this call signature, without running the
        function or selecting a harness (the signature is traced and
        detected once, as a call would)."""
        leaves, spec = tree_flatten((args, kwargs))
        return self._lookup(self._unwrap(leaves), spec).report

    def _build_graph(self, entry: CompiledEntry) -> None:
        """Trace mode: select once per match and pin the winners into the
        rewritten graph, each anchor traced under containment; rebuilt once
        if the joint search moves a pin, and once more for each match
        containment disables."""
        joint_moves = 0
        contain = self._containment(entry)
        grad = any(entry.grad_inputs)

        def ctx_factory(m):
            ctx = self._ctx_factory(m)
            ctx.differentiable = grad
            return ctx

        while True:
            matches = entry.enabled()
            selections, schedules, fuses = [], [], []

            def on_select(m, h, ctx):
                if selections and selections[-1][0] is m:
                    selections.pop(), schedules.pop(), fuses.pop()
                selections.append((m, h.name))
                schedules.append(ctx.schedule)
                fuses.append(ctx.fuse)

            try:
                entry.rewritten = rewrite_graph(
                    entry.gm, matches, self._selector(entry),
                    ctx_factory, on_select=on_select,
                    needed=entry.needed_for(matches), contain=contain)
            except R.ReferenceFallback as rf:
                self._disable(entry, rf)
                continue
            entry.selections, entry.schedules, entry.fuses = \
                selections, schedules, fuses
            entry.runs = differentiable_graph(entry.rewritten) if grad \
                else entry.rewritten
            if joint_moves or not self._maybe_joint(entry):
                break
            joint_moves += 1
        self._maybe_persist(entry)

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
        return self._entry_for(self._unwrap(leaves), spec).rewritten

    # -- selection -----------------------------------------------------------

    def _select(self, m: D.Match, binding=None, ctx=None) -> H.Harness:
        """The policy's harness, unless it is quarantined: then the next
        candidate as containment orders them (the platform default first,
        at its default variant), with a ``LilacContainmentWarning`` and a
        ``quarantine_skips`` count each time.  With every candidate
        quarantined the policy's own stands: an answer is still owed, and
        containment at the call is the enforcement."""
        h = self.registry.select(m.computation, m.format, self.platform,
                                 self.mode, policy=self.policy,
                                 binding=binding, ctx=ctx)
        q = R.shared_quarantine()
        vkey = variant_key(getattr(ctx, "schedule", None),
                           getattr(ctx, "fuse", None))
        if not R.quarantined(q, m.computation, h.name, vkey):
            return h
        alt = R.next_candidate(self.registry, q, m, self.platform,
                               self.mode, {h.name})
        if alt is None:
            return h
        self.resilience_stats.quarantine_skips += 1
        R.warn_skip(m.computation, h.name, vkey,
                    f"{alt.name!r} runs in its place")
        if ctx is not None:
            ctx.schedule = ctx.fuse = None
        return alt

    def _selector(self, entry: CompiledEntry):
        """The select function of a call: under ``policy='autotune'``,
        the tuner once per match per signature, then its pinned (harness,
        schedule, fuse); a fallback decision (nothing measurable) stays
        re-tunable on a later call."""
        if self.policy != "autotune":
            return self._select
        index = {m.anchor: i for i, m in enumerate(entry.flat())}
        q = R.shared_quarantine()

        def select(m, binding, ctx):
            i = index[m.anchor]
            pin = entry.pins.get(i)
            if pin is not None and R.quarantined(
                    q, m.computation, pin[0], variant_key(pin[1], pin[2])):
                del entry.pins[i]           # quarantined since: re-tune
                self.resilience_stats.quarantine_skips += 1
                R.warn_skip(m.computation, pin[0],
                            variant_key(pin[1], pin[2]), "the tuner selects again")
                pin = None
            if pin is not None:
                try:
                    h = self.registry.get(m.computation, pin[0])
                    _, ctx.schedule, ctx.fuse = pin
                    return h
                except KeyError:
                    del entry.pins[i]       # harness set changed: re-tune
            h = self._select(m, binding, ctx)
            dec = self.registry.autotuner.last_decision
            if dec is not None and dec.definitive:
                entry.pins[i] = dec.as_pin()
            return h

        return select

    def _ctx_factory(self, m: D.Match) -> H.CallCtx:
        return H.CallCtx(mode=self.mode, cache=self.cache, format=m.format,
                         platform=self.platform, epilogue=m.epilogue)

    # -- execution -----------------------------------------------------------

    def _dispatch_plan(self, plan: P.ExecutablePlan, got,
                       traced: bool = False):
        """``plan``'s program on the tensors ``plan.match`` (or, for a
        ``traced`` call, ``plan.traces``) returned in ``got``, its outputs
        wrapped back at the call's ``vmap`` levels there
        (``levels.rewrap``)."""
        tensors, outer = got
        self.last_report = plan.report
        self.last_selections = list(plan.selections)
        self.last_schedules = list(plan.schedules)
        outs = plan.trace(tensors) if traced else plan.run(tensors)
        if outer:
            outs = levels.rewrap(outs, outer)
        return tree_unflatten(outs, plan.out_spec)

    def _serve(self, plan: P.ExecutablePlan, got, flat, spec):
        """One plan call (``got``: what ``plan.match`` returned); no
        validation runs on it (no sync), but a sampled shadow check may:
        a batched call's counted by element, as an unplanned one's."""
        out = self._dispatch_plan(plan, got)
        if self._in_shadow:
            return out
        if plan.transform is not None and any(
                levels.batched(unwrap(flat[p])) for p in plan.tensor_pos):
            return self._maybe_shadow_batched(
                flat, spec, out,
                [unwrap(flat[p]) for p in plan.tensor_pos],
                lambda reason: self._shadow_divergence(plan, reason))
        r = self._shadow.effective()
        if r > 0.0:
            out = self._maybe_shadow(plan, flat, spec, out, r)
        return out

    def _maybe_shadow(self, plan, flat, spec, out, r):
        """Sampled shadow verification, stratified without RNG state: at
        rate r, call n is checked iff the integer part of n*r advances, so
        every window of 1/r calls holds one check.  ``r`` is the adaptive
        effective rate."""
        if not self._sampled(1, r):
            return out
        ref = self._shadow_ref(flat, spec, out, 1)
        if ref is out:
            return out
        # the plan's answer is wrong: serve the uncompiled one for this
        # call, quarantine what the plan selected and tear it down, so the
        # next call selects, tunes and bakes again
        self._shadow_divergence(plan, "shadow divergence")
        return ref

    def _maybe_shadow_batched(self, flat, spec, out, tensors,
                              on_divergence: Callable[[str], None]):
        """The sampled shadow check of a vmapped call, planned or not: the
        uncompiled function runs on the same batched values, once an
        element of the outermost ``vmap`` level (``_shadow_ref``), and each
        element is held to the plan shadow's bound (``outputs_close``
        reads a batched verdict).  The call stands for one call an
        element, so the sampling counter and ``shadow_checks`` advance by
        the batch size.  A divergence serves the uncompiled answer and
        calls ``on_divergence`` (a plan's teardown, or the unplanned
        entry's), as a plan's does.  A call traced into another graph, or
        captured into a CUDA graph, is not checked: the check would be
        recorded with it."""
        r = self._shadow.effective()
        if r <= 0.0 or self._in_shadow \
                or P.under_trace(tensors) \
                or (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
            return out
        k = levels.batch_size(tensors)
        if not self._sampled(k, r):
            return out
        ref = self._shadow_ref(flat, spec, out, k)
        if ref is not out:
            on_divergence("shadow divergence (vmapped call)")
        return ref

    def _entry_divergence(self, entry: CompiledEntry, reason: str) -> None:
        """An unplanned call of ``entry`` diverged: quarantine what it
        selected (``last_selections``) and unwind the entry."""
        self._shadow.spike(reason)
        q = R.shared_quarantine()
        for (m, name), sched in zip(self.last_selections,
                                    self.last_schedules):
            q.add(m.computation, name, variant_key(sched, None),
                  reason=reason, site=name)
            i = entry.index_of(m)
            if i is not None and entry.pins.get(i, (None,))[0] == name:
                del entry.pins[i]
        self._unwind(entry, reason)

    def _sampled(self, k: int, r: float) -> bool:
        """Advance the shadow counter by ``k`` calls: whether a sample at
        rate ``r`` falls among them."""
        n0 = self._shadow_ctr
        self._shadow_ctr = n = n0 + k
        return int(n * r) != int(n0 * r)

    def _shadow_ref(self, flat, spec, out, k: int):
        """One shadow check of ``k`` calls' output ``out``: ``out`` itself
        when the uncompiled program agrees, else the uncompiled program's
        answer, with the divergence counted.  A vmapped call's uncompiled
        program runs once an element of its outermost ``vmap`` level
        (``levels.map_outer``), as a loop over the batch: a batching rule
        of the user's program (torch's for an ``etf,efd->etd`` einsum
        copies its weights once an element) cannot make the check fail.
        One that fails all the same checks nothing: ours is kept, and it
        counts in ``shadow_errors``, not ``shadow_checks``."""
        leaves = self._unwrap(flat)

        def uncompiled(vals):
            args, kwargs = tree_unflatten(vals, spec)
            return self.fn(*args, **kwargs)

        self._in_shadow = True
        try:
            ref = levels.map_outer(uncompiled, leaves)
            if ref is None:
                ref = uncompiled(leaves)
        except Exception:
            self.resilience_stats.shadow_errors += 1
            return out          # the uncompiled program failed; keep ours
        finally:
            self._in_shadow = False
        self.resilience_stats.shadow_checks += k
        if R.outputs_close(out, ref) \
                and not faults.check("shadow_diverge", "dispatch"):
            self._shadow.clean()
            return out
        self.resilience_stats.shadow_divergences += 1
        return ref

    def _shadow_divergence(self, plan: P.ExecutablePlan, reason: str):
        self._shadow.spike(reason)
        q = R.shared_quarantine()
        for (m, name), sched in zip(plan.selections, plan.schedules):
            q.add(m.computation, name, variant_key(sched, None),
                  reason=reason, site=name)
        for entry in self._compiled.values():
            if entry.plan is plan:
                self._unwind(entry, reason)

    def report_divergence(self, reason: str = "external divergence"):
        """An out-of-band check (an application's checksum, a serving
        tier's request shadow) saw this function return a wrong answer.
        Responds as to a shadow divergence: quarantine what the live plans
        (or the pins of a signature not baked yet) selected, tear them
        down so the next call re-tunes, spike the shadow rate."""
        self.resilience_stats.shadow_divergences += 1
        plans = []
        q = R.shared_quarantine()
        for entry in self._compiled.values():
            if entry.plan is not None:
                if entry.plan not in plans:
                    plans.append(entry.plan)
                continue
            for i, (name, sched, fuse) in list(entry.pins.items()):
                q.add(entry.flat()[i].computation, name,
                      variant_key(sched, None), reason=reason, site=name)
            if entry.pins:
                self._unwind(entry, reason)
        for plan in plans:
            self._shadow_divergence(plan, reason)
        if not plans:
            self._shadow.spike(reason)

    def resilience_info(self) -> Dict[str, Any]:
        """Containment, quarantine and shadow counters of this function,
        the tuner's quarantine skips (process-wide) and the shared
        quarantine store's view."""
        q = R.shared_quarantine()
        return {
            "containment": self.resilience_stats.as_dict(),
            "unread_traced": self.unread_traced,
            "tuner_quarantine_skips":
                self.registry.autotuner.stats.quarantine_skips,
            "quarantine": q.stats.as_dict(),
            "quarantine_active": len(q.active()),
            "quarantine_path": str(q.path),
            "shadow_rate": self._shadow.effective(),
            "shadow": self._shadow.snapshot(),
            "disabled_matches": sum(len(e.disabled)
                                    for e in self._compiled.values()),
        }

    def _note_hot(self, plan: P.ExecutablePlan) -> None:
        """Move ``plan`` to the front of the hot list (bounded)."""
        self._last_plan = plan
        hot = self._hot_plans
        if hot and hot[0] is plan:
            return
        if plan in hot:
            hot.remove(plan)
        hot.insert(0, plan)
        del hot[self._HOT_PLAN_LIMIT:]

    def _drop_plan(self, entry: CompiledEntry) -> None:
        plan, entry.plan = entry.plan, None
        if plan is None:
            return
        if self._last_plan is plan:
            self._last_plan = None
        if plan in self._hot_plans:
            self._hot_plans.remove(plan)
        plan.release()

    def __call__(self, *args, **kwargs):
        if torch.compiler.is_dynamo_compiling():
            # dynamo traces a torch.compile'd caller: the call is one
            # opaque node (trace mode) or a graph break (host mode); the
            # baseline's own program is traced as the caller's code
            if not self.enabled:
                return self.fn(*args, **kwargs)
            return self._dynamo_call(*args, **kwargs)
        return self._call(*args, **kwargs)

    def _call(self, *args, **kwargs):
        if not self.enabled:
            return self.fn(*args, **kwargs)
        flat, spec = tree_flatten((args, kwargs))
        # steady state: guard check -> one replay.  A registry epoch moved
        # by any (re-)registration refuses a plan
        epoch = self.registry.epoch
        last = self._last_plan
        candidates = ([last] if last is not None else []) + \
            [p for p in self._hot_plans if p is not last]
        for plan in candidates:
            if plan.registry_epoch != epoch:
                continue
            got = plan.match(spec, flat)
            if got is not None:
                self._note_hot(plan)
                return self._serve(plan, got, flat, spec)
        leaves = self._unwrap(flat)
        # a call traced into another graph (a user's make_fx, AOT
        # autograd's trace of a torch.compile step) detects and selects
        # outside the ambient modes, once a signature; a plan that can
        # serve a trace traces its program into the graph, else the call
        # traces its rewritten graph or the interpreter, and a resolved
        # entry bakes under the trace (its capture deferred)
        traced = P.under_trace(leaves)
        entry = self._entry_for(leaves, spec, traced)
        tensors = [leaves[i] for i in entry.tensor_pos]
        plan = entry.plan
        if plan is not None and plan.registry_epoch == epoch:
            got = plan.traces(spec, flat) if traced else plan.match(spec, flat)
            if got is not None:
                if traced:
                    return self._dispatch_plan(plan, got, traced=True)
                self._note_hot(plan)
                return self._serve(plan, got, flat, spec)
        if self.mode == "trace":
            self.traced_calls["rewritten_graph"] += traced
            outs = list(entry.runs(*tensors))
            self.last_selections = list(entry.selections)
            self.last_schedules = list(entry.schedules)
            if self.bake_enabled and not entry.no_bake:
                self._maybe_bake_graph(entry, flat, tensors, spec)
            out = tree_unflatten(outs, entry.out_spec)
        else:
            self.traced_calls["interpreter"] += traced
            out = self._interpret(entry, flat, tensors, spec, traced)
        if entry.batched:
            out = self._maybe_shadow_batched(
                flat, spec, out, tensors,
                lambda reason: self._entry_divergence(entry, reason))
        return out

    def _containment(self, entry: CompiledEntry) -> R.Containment:
        def on_quarantine(m, harness, vkey, reason):
            # an incident: densify shadow checks until a clean streak
            self._shadow.spike(f"quarantine: {reason}")
            i = entry.index_of(m)
            pin = entry.pins.get(i) if i is not None else None
            if pin is not None and pin[0] == harness:
                del entry.pins[i]
            self._unwind(entry, reason)

        def on_unread():
            self.unread_traced += 1

        return R.Containment(self.registry, R.shared_quarantine(),
                             on_quarantine=on_quarantine,
                             stats=self.resilience_stats,
                             read_batched=not entry.validated,
                             on_unread=on_unread)

    def _unwind(self, entry: CompiledEntry, reason: str) -> None:
        """A quarantine or divergence made the entry's resolution stale:
        drop its plan (freeing a CUDA graph's pool and buffers), its
        persisted plan record and its joint result, so the next call
        selects, tunes and bakes again.  Pins still valid stay."""
        entry.rewritten = entry.runs = None     # trace mode rebuilds
        entry.validated = False
        entry.persisted = False
        entry.joint_done = False
        entry.joint = None
        self._reset_bake(entry)
        self._drop_plan(entry)
        pc = self._plan_cache
        if pc is not None and entry.cache_key is not None:
            pc.drop(entry.cache_key, reason)

    def _disable(self, entry: CompiledEntry, rf: R.ReferenceFallback):
        i = entry.index_of(rf.match)
        if i is None or i in entry.disabled:
            raise rf        # not this entry's match: nothing to disable
        entry.disabled.add(i)

    def _interpret(self, entry: CompiledEntry, flat, tensors, spec,
                   traced: bool = False):
        """Host mode: run the traced graph with harness calls under
        containment, recording what a plan needs.  A ReferenceFallback
        disables one match and the call runs again.  ``traced``: the call
        is traced into another graph, where a harness with host-side work
        (a marshal clause or a lifecycle hook) has no concrete matrix to
        read: on the CPU its match runs as the plain graph node for this
        call only (nothing is quarantined, and the call records no plan);
        on the card the call raises (:func:`_concrete_only`).  Each
        retry drops one match, so the loop is bounded by twice the match
        count + 1."""
        recorder = (P.PlanRecorder()
                    if self.bake_enabled and not entry.no_bake else None)

        def ctx_factory(m):
            ctx = self._ctx_factory(m)
            if recorder is not None:
                ctx.cache = P.recording_cache(ctx.cache,
                                              recorder.slot(m).buffers)
            return ctx

        selections: List[Tuple[D.Match, str]] = []
        schedules: List[Optional[Dict[str, Any]]] = []

        def on_select(m, h, ctx):
            if selections and selections[-1][0] is m:
                # containment's retry of the same anchor: a replacement
                selections.pop(), schedules.pop()
            selections.append((m, h.name))
            schedules.append(ctx.schedule)
            if recorder is not None:
                recorder.begin(m, h, ctx.schedule, ctx.fuse)

        contain = self._containment(entry)
        select = self._selector(entry)
        if traced:
            select = _concrete_only(select)
        plain: set = set()      # ids of the matches run plain this call
        for _ in range(2 * len(entry.flat()) + 1):
            matches = [m for m in entry.enabled() if id(m) not in plain]
            try:
                outs = run_rewritten(entry.gm, matches, select,
                                     tensors, ctx_factory,
                                     on_select=on_select,
                                     needed=entry.needed_for(matches),
                                     contain=contain)
                break
            except R.ReferenceFallback as rf:
                self._disable(entry, rf)
            except _HostSideWork as hw:
                # the top-level match holding it (a scan runs plain whole)
                plain.update(id(m) for m in matches
                             if hw.match in D.flat_matches([m]))
                self.traced_calls["plain_anchors"] += 1
            selections.clear()
            schedules.clear()
        entry.validated = entry.batched
        self.last_selections = selections
        self.last_schedules = schedules
        moved = self._maybe_joint(entry)
        self._maybe_persist(entry)
        if recorder is not None and not moved:
            # pins that just moved under the joint search: this call ran
            # the pre-joint assignment, the next one records and bakes
            self._maybe_bake(entry, recorder, flat, tensors, spec)
        return tree_unflatten(outs, entry.out_spec)

    # -- the plan's life cycle -----------------------------------------------

    def _maybe_joint(self, entry: CompiledEntry) -> bool:
        """Run the joint search once per entry, after every match has a
        definitive pin.  Returns True when it moved a pin.  It re-costs the
        tuner's recorded components and times nothing."""
        if entry.joint_done or self.policy != "autotune":
            return False
        # inner bindings on a scan's closed-over tensors name the outer
        # nodes: an inner match and an outer one share a matrix
        matches = D.flat_matches(entry.report.matches, loop_invariant=True)
        if len(matches) < 2:
            entry.joint_done = True     # nothing to couple
            return False
        if len(entry.pins) != len(matches):
            return False                # not yet resolved
        width = PS.beam_width()
        entry.joint_done = True
        if width <= 0:
            return False                # LILAC_TORCH_SEARCH_BEAM=0: greedy
        res = PS.optimize_entry(
            matches, entry.pins, registry=self.registry,
            tuner=self.registry.autotuner, platform=self.platform,
            mode=self.mode, cache=self.cache,
            reuse=self.marshal_policy.reuse, width=width)
        if res is None:
            return False
        entry.joint = res.report()
        moved = False
        for i, cand in enumerate(res.assignment):
            if entry.pins.get(i) != cand.pin():
                entry.pins[i] = cand.pin()
                moved = True
        if moved:
            entry.persisted = False     # re-persist the joint pins
            self._drop_plan(entry)      # baked on the pre-joint pins
        return moved

    def _resolved(self, entry: CompiledEntry) -> bool:
        """Every selection is definitive: always under an explicit or the
        default policy; under autotune once every enabled match is pinned
        (or tuning is off, which makes the defaults deterministic)."""
        if self.policy != "autotune" or not entry.enabled():
            return True
        return autotune_disabled() or all(
            i in entry.pins for i in range(len(entry.flat()))
            if i not in entry.disabled)

    def _maybe_persist(self, entry: CompiledEntry) -> None:
        pc = self._plan_cache
        if pc is None or entry.persisted or entry.cache_key is None \
                or not self._resolved(entry):
            return
        entry.persisted = True
        if entry.has_scan():
            # a scan_body match holds its body graph and inner matches as
            # live objects, with no address in the outer graph: the entry
            # stays in this process's memory
            return
        try:
            ser = P.serialize_matches(entry.gm, entry.report.matches)
        except P.PlanBakeError:
            return                      # unaddressable match: keep in memory
        rec = {"matches": ser, "n_eqns": P.n_ops(entry.gm),
               "detect_digest": P.detect_digest(ser),
               "pins": {str(i): [n, s, f]
                        for i, (n, s, f) in entry.pins.items()}}
        if entry.joint is not None:
            rec["joint"] = entry.joint
        pc.put(entry.cache_key, rec)

    def _disable_bake(self, entry: CompiledEntry, reason: str) -> None:
        """Stop baking this entry and drop its plan, whose buffers and
        strong references would otherwise stay resident."""
        entry.no_bake = True
        entry.bake_error = reason
        self._drop_plan(entry)

    def _bakeable(self, entry: CompiledEntry, harnesses, tensors) -> bool:
        """Whether this call may bake (disabling the entry where it never
        may)."""
        if entry.no_bake or not self._resolved(entry):
            return False
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            return False                # under a capture: a later call may
        if self.cache is None and any(h.marshal for h in harnesses):
            # marshal_policy='off' promises a repack every call: hoisting
            # one into a plan would quietly bring caching back
            self._disable_bake(entry, "marshal_policy='off' forbids "
                               "hoisting repacks; the interpreter repacks "
                               "every call")
            return False
        for h in harnesses:
            # a plan would freeze the first call's host-side behavior: the
            # lifecycle hooks and the persistent state are read every call
            if (not getattr(h, "bakeable", True) or h.setup is not None
                    or h.teardown is not None or h.persistent):
                self._disable_bake(
                    entry, f"harness {h.name!r} is stateful or opted out of "
                           f"baking (bakeable=False / lifecycle hooks / "
                           f"persistent)")
                return False
        if P.under_trace(tensors):
            # baking under a trace hoists nothing traced (a traced call
            # selects no marshaling harness: ``_concrete_only``); vmap
            # levels (a batched program traced on traced tensors) defer
            # the bake to a concrete call, and a plan already baked stays
            return entry.plan is None \
                and not any(map(levels.batched, tensors))
        return True

    def _keep_or_rebake(self, entry: CompiledEntry) -> bool:
        """With a plan in place, whether a new one may be baked: False once
        the re-bakes stop paying off."""
        plan = entry.plan
        if plan is not None and entry.rebakes >= self._REBAKE_LIMIT \
                and plan.hits == 0:
            # operands change faster than a plan pays off
            self._disable_bake(entry, "rebake thrash (operands change per "
                                      "call)")
            return False
        return True

    def _install(self, entry: CompiledEntry, bake: Callable) -> None:
        if not self._keep_or_rebake(entry):
            return
        try:
            baked = bake()
        except Exception as e:     # a capture the card refused, etc.
            self._disable_bake(entry, repr(e))
            return
        if entry.plan is not None:
            entry.rebakes += 1
            self._drop_plan(entry)
        entry.plan = baked
        self._note_hot(baked)

    def _maybe_bake(self, entry: CompiledEntry, recorder: P.PlanRecorder,
                    flat, tensors, spec) -> None:
        matches = entry.enabled()
        if not recorder.complete_for(matches):
            return
        harnesses = [recorder.slots[id(m.anchor)].harness for m in matches]
        if not self._bakeable(entry, harnesses, tensors):
            return
        plan = entry.plan
        got = plan.fits(spec, flat) if plan is not None else None
        if (got is not None and plan.consts_ok()
                and plan.registry_epoch == self.registry.epoch
                and plan.same_hoisted(recorder)):
            # content-identical operands under new identities: the data
            # plane served the same buffers, so only the guards move
            try:
                plan.refresh_guards(flat, got[0])
            except Exception as e:
                self._disable_bake(entry, repr(e))
                return
            self._note_hot(plan)
            return
        self._install(entry, lambda: P.bake_plan(
            gm=entry.gm, matches=matches, needed=entry.needed_for(matches),
            recorder=recorder, raw_flat=flat, tensors=tensors,
            tensor_pos=entry.tensor_pos, in_spec=spec,
            out_spec=entry.out_spec, report=entry.report, mode=self.mode,
            platform=self.platform, registry_epoch=self.registry.epoch,
            static_leaves=self._static_leaves))

    def _maybe_bake_graph(self, entry: CompiledEntry, flat, tensors,
                          spec) -> None:
        """Trace mode: the rewritten graph is the plan's program."""
        harnesses = [self.registry.get(m.computation, name)
                     for m, name in entry.selections]
        if not self._bakeable(entry, harnesses, tensors):
            return
        self._install(entry, lambda: P.bake_graph_plan(
            gm=entry.rewritten, raw_flat=flat, tensors=tensors,
            tensor_pos=entry.tensor_pos, in_spec=spec,
            out_spec=entry.out_spec, report=entry.report,
            selections=list(entry.selections),
            schedules=list(entry.schedules), fuses=list(entry.fuses),
            platform=self.platform, registry_epoch=self.registry.epoch,
            static_leaves=self._static_leaves))

    def invalidate_plans(self) -> None:
        """Drop every baked plan (not the persistent cache): the next call
        of each signature records and bakes again."""
        for entry in self._compiled.values():
            entry.plan = None
            self._reset_bake(entry)
            entry.rebakes = 0
        self._last_plan = None
        self._hot_plans.clear()

    def executable_plan(self, *args, **kwargs) -> Optional[P.ExecutablePlan]:
        """The baked plan of this call signature, or None (not resolved
        yet, baking off, or unbakeable).  Runs nothing."""
        leaves, spec = tree_flatten((args, kwargs))
        return self._entry_for(self._unwrap(leaves), spec).plan

    def prewarm(self, *signatures) -> Dict[str, Any]:
        """Bake a plan per call signature before traffic arrives.

        Each signature is a tuple of positional arguments; a leaf that is
        a ``(shape, dtype)`` pair is made as zeros on this function's
        device.  One call per signature runs the whole detect -> tune ->
        bake life cycle here (or rehydrates it from the plan cache).
        Returns per signature ``{seconds, baked, detect_calls,
        from_plan_cache}`` (``seconds``: the call's trace, detection,
        selection and bake, on the host's clock) and the totals;
        ``detect_calls`` stays 0 on a plan-cache warm start.  The zeros
        made from specs are throwaway, so a CUDA graph captures static
        buffers at their positions from the start: a later call's tensor
        there is copied in, not re-captured on."""
        def is_spec(x):
            return (isinstance(x, tuple) and len(x) == 2
                    and isinstance(x[1], torch.dtype)
                    and isinstance(x[0], (tuple, list, torch.Size)))

        def materialize(x):
            return torch.zeros(tuple(x[0]), dtype=x[1],
                               device=self.platform) if is_spec(x) else x

        per_sig: List[Dict[str, Any]] = []
        for sig in signatures:
            leaves, spec = tree_flatten(tuple(sig), is_leaf=is_spec)
            made = [materialize(x) for x in leaves]
            args = tree_unflatten(made, spec)
            flat, in_spec = tree_flatten((args, {}))
            made_ids = {id(t) for t, x in zip(made, leaves) if is_spec(x)}
            before = self.stats["detects"]
            t0 = time.perf_counter()
            self._static_leaves = frozenset(
                i for i, t in enumerate(flat) if id(t) in made_ids)
            try:
                self(*args)
            finally:
                self._static_leaves = frozenset()
            seconds = time.perf_counter() - t0
            entry = self._entry_for(self._unwrap(flat), in_spec)
            per_sig.append({
                "seconds": seconds,
                "baked": entry.plan is not None,
                "detect_calls": self.stats["detects"] - before,
                "from_plan_cache": any("rehydrated from plan cache" in line
                                       for line in entry.report.log),
            })
        return {
            "signatures": per_sig,
            "n_signatures": len(per_sig),
            "baked": sum(1 for x in per_sig if x["baked"]),
            "detect_calls": sum(x["detect_calls"] for x in per_sig),
            "plan_cache_hits": sum(1 for x in per_sig
                                   if x["from_plan_cache"]),
        }

    def plan_info(self) -> Dict[str, Any]:
        """Bake status of this function's entries."""
        entries = list(self._compiled.values())
        plans = [e.plan for e in entries if e.plan is not None]
        pc = self._plan_cache
        return {
            "entries": len(entries),
            "baked": len(plans),
            "plan_hits": sum(p.hits for p in plans),
            "rebakes": sum(e.rebakes for e in entries),
            "no_bake": sum(1 for e in entries if e.no_bake),
            "bake_errors": [e.bake_error for e in entries if e.bake_error],
            "joint_searched": sum(1 for e in entries if e.joint is not None),
            "joint": [e.joint for e in entries if e.joint is not None],
            "plan_cache": str(pc.path) if pc is not None else None,
            "plan_cache_stats": pc.stats.as_dict() if pc is not None
            else None,
            "plans": [p.describe() for p in plans],
            "trace_serves": sum(p.trace_serves for p in plans),
            "traced_calls": dict(self.traced_calls),
        }


class _HostSideWork(Exception):
    """Raised by :func:`_concrete_only`'s selection: ``match``'s harness
    does host-side work that a traced call cannot feed."""

    def __init__(self, match):
        super().__init__(match.computation)
        self.match = match


def _concrete_only(select: Callable) -> Callable:
    """``select`` for a host-mode call traced into another graph, where a
    harness that marshals on the host or has lifecycle hooks has no
    concrete matrix to read (``ell_from_csr`` is numpy).  On the CPU its
    match runs as the plain graph node for the call (it raises
    :class:`_HostSideWork`), as the reference's traced call falls back for
    a position that feeds a marshal clause.  On the card no plain program
    stands in for a kernel: the call raises, naming ``mode='trace'``."""
    def pick(m, binding, ctx):
        h = select(m, binding, ctx)
        if h.marshal or h.setup is not None or h.persistent:
            if any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
                   for v in binding.values()):
                raise RuntimeError(
                    f"lilac.compile(mode='host') traced into another graph "
                    f"(make_fx, a torch.compile trace) on the card: "
                    f"{h.name} does host-side work on the matrix, which a "
                    f"trace cannot feed, and no plain program stands in for "
                    f"its kernel; compile with mode='trace' to put the "
                    f"call into the trace")
            raise _HostSideWork(m)
        return h

    return pick


_HOST_GRAPH_BREAK = (
    "lilac.compile(mode='host') runs on concrete tensors (its harnesses "
    "marshal the matrix on the host, which a traced matrix cannot feed), so "
    "a torch.compile'd caller breaks its graph at the call; compile with "
    "mode='trace' to put the call into the caller's graph "
    "(fullgraph=True)")


def _dynamo_entry(fn: LilacFunction) -> Callable:
    """The call dynamo meets for ``fn`` inside a ``torch.compile``'d
    caller, never inlined.  Trace mode: one opaque node of the caller's
    graph (``torch.compiler.allow_in_graph``), which AOT autograd's trace
    then runs on its fake tensors, so the entry's program (its
    ``lilac_torch::*`` custom-op nodes) lands in the caller's graph.  Host
    mode: a graph break (``torch.compiler.disable``), the call running on
    concrete tensors through its plan; under ``fullgraph=True`` dynamo's
    error names :data:`_HOST_GRAPH_BREAK`.  It holds ``fn`` weakly, so
    that ``fn`` is freed when its last user lets go (its plans and
    layouts with it), not at the next garbage collection."""
    ref = weakref.ref(fn)

    def call(*args, **kwargs):
        return ref()._call(*args, **kwargs)

    if fn.mode == "trace":
        return torch.compiler.allow_in_graph(call)
    try:
        return torch.compiler.disable(call, reason=_HOST_GRAPH_BREAK)
    except TypeError:               # a torch whose disable takes no reason
        return torch.compiler.disable(call)


@dataclasses.dataclass
class CompileOptions:
    """Configuration for :func:`compile` (the paper's Fig. 1 pass).

    ``mode``      'trace' (the default: the rewritten graph, jit-safe
                  harnesses only) or 'host' (eager with the data plane —
                  the paper's runtime model, where marshaling harnesses
                  run).
    ``policy``    'default' | 'autotune' | an explicit harness name.
    ``platform``  'cuda' (the default; raises without a card) or 'cpu'.
    ``device``    alternative spelling: its type picks the platform.
    ``enabled``   False runs the original function (the A/B baseline): no
                  trace, no detection, no kernel.
    ``marshal_policy``  a :class:`~repro_torch.core.marshal.MarshalPolicy`,
                  or 'shared' (default: one data plane per function) or
                  'off' (every call repacks); its ``reuse`` is the calls a
                  matrix over which the autotuner amortizes a repack.
    ``bake``      True (default): bake each resolved entry into an
                  :class:`~repro_torch.core.plan.ExecutablePlan` (a CUDA
                  graph on the card); False keeps the interpreter on every
                  call.
    ``plan_cache``  the persistent plan cache: None/'default' resolves
                  ``LILAC_TORCH_PLAN_CACHE`` (default
                  ~/.cache/lilac-torch/plans.json), 'off'/False disables
                  it, a path or a :class:`~repro_torch.core.plan.PlanCache`
                  names one.
    ``registry``/``detector``/``cache``  the harness registry, the
                  detector and the data plane; None picks the global
                  registry, the default detector and a data plane of the
                  function's own.  Pass one DataPlane as ``cache`` to
                  several compiled functions to share marshaled buffers.
                  A function with its own detector keeps no persistent
                  plan records (they key the default detection): naming
                  a ``plan_cache`` beside it raises ``ValueError``.

    The reference's ``donate_args`` has no counterpart (torch has no
    buffer donation), so it is an unknown option here.
    """
    mode: str = "trace"
    policy: str = "default"
    platform: Optional[str] = None
    device: Any = None
    enabled: bool = True
    marshal_policy: Optional[Any] = None
    bake: bool = True
    plan_cache: Any = None
    registry: Optional[H.HarnessRegistry] = None
    detector: Optional[D.Detector] = None
    cache: Optional[DataPlane] = None


_OPTION_FIELDS = {f.name for f in dataclasses.fields(CompileOptions)}


def compile(fn: Optional[Callable] = None, *,
            options: Optional[CompileOptions] = None,
            **overrides) -> LilacFunction:
    """The single LiLAC entry point: pass ``fn`` through the pass.

    Usable directly (``lilac.compile(fn, mode="host")``), with an options
    dataclass (``lilac.compile(fn, options=CompileOptions(...))``, where
    keyword arguments override its fields), or as a decorator
    (``@lilac.compile(policy="autotune")``).  The keywords are the
    fields of :class:`CompileOptions`; any other raises ``TypeError``.
    """
    bad = set(overrides) - _OPTION_FIELDS
    if bad:
        raise TypeError(f"unknown compile option(s): {sorted(bad)}")
    opts = options if options is not None else CompileOptions()
    if overrides:
        opts = dataclasses.replace(opts, **overrides)
    if fn is None:
        return lambda f: compile(f, options=opts)
    return LilacFunction(fn, **{k: getattr(opts, k) for k in _OPTION_FIELDS})
