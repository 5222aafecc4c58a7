"""Executable plans: steady-state dispatch without the interpreter (paper
§4.2/§5).

Counterpart of ``repro.core.plan``.  The paper's runtime claim is that an
inserted harness call costs no more than a hand-written integration.  The
data plane amortizes the repacks, but a host-mode call still fingerprints
its matrix (a device-to-host copy of a sample per key tensor) and walks the
FX graph in Python.  This module turns a resolved rewrite into a
compile-once artifact, in two layers:

* :class:`ExecutablePlan` — once every match of a ``CompiledEntry`` has a
  definitive ``(harness, schedule, fuse)`` selection, the rewritten
  program is baked: marshaled operands (the ELL/BCSR layouts the data
  plane built) are hoisted out of it as constants (:class:`_PlanBuffers`
  stands in for the data plane, so the program never fingerprints), and on
  the card the program is captured in one ``torch.cuda.CUDAGraph``.  A
  call is then a guard check and a replay.  On the CPU the plan runs the
  same program eagerly.  Trace-mode entries bake their rewritten
  ``GraphModule`` the same way.
* :class:`PlanCache` — a schema-versioned JSON store
  (``~/.cache/lilac-torch/plans.json``) mapping ``(graph fingerprint,
  platform, mode, policy, declared marshal reuse)``, under a
  registry-fingerprint header, to the serialized detection report and the
  pinned ``(harness, schedule, fuse)`` decisions.  A warm process re-traces
  the function (cheap), fingerprints the graph and rehydrates matches and
  pins: detection and tuning are skipped.

**Guards** are O(arity) and read no bytes: every leaf's shape, dtype and
device, Python leaves by value, and the leaves the hoisted buffers were
derived from (the marshal sources) by :func:`~repro_torch.core.marshal.
version_token` — the tensor's storage, address, view and ``_version``, so
an in-place edit busts the plan as it misses the data plane.  A marshal
source with no version counter (an inference tensor) is guarded by its
:func:`~repro_torch.core.marshal.checksum` as well, one pass on the card
each call, since no version moves when it is written.  A
``TrackedArray`` operand is guarded by its version too.  A leaf that is a
fake or functional tensor, or a tensor subclass, never hits a plan, nor
does a call under an ambient trace (``make_fx``): the call runs the
interpreter (host mode) or the rewritten graph (trace mode).

**Plans under transforms** (docs/transforms.md).  A call under
``torch.func.vmap``, one whose tensors require grad (``.backward()``) and
one under ``torch.func.grad`` each bake a plan of their own (the leaf
templates key a ``torch.func`` level's kind and ``requires_grad``) and are
then served by it, with no detection, fingerprint or selection:

* a **batched** plan (the call's outermost levels are ``vmap`` levels)
  guards each level's batch size and each leaf's batch dim, and the
  shapes and strides below the levels (``levels.peel``); a different B or
  batch dim is a guard miss and a new bake.  Its program is ``make_fx``
  of ``torch.func.vmap`` of the per-element program, traced once on the
  tensors below the levels (:func:`batched_program`), so each custom op is
  one node for the batch (K1/K2/K4 one launch, K3 the vectors as
  columns).  A call unwraps its leaves, runs the program and wraps the
  outputs back at the call's own levels (``levels.rewrap``);
* a **gradient-carrying** plan (a leaf requires grad at any level) runs
  its program eagerly, with the hoisted buffers, autograd recording
  through the harnesses: a host-mode ``vjp`` clause's
  ``rewrite.HarnessCall``, a custom op's differentiable call
  (``kernels.common.differentiable``: trace-mode graphs and batched
  programs are retargeted to it).  A CUDA-graph replay records no
  autograd graph, so such a plan takes no CUDA graph (``plan_info()``
  says so: ``runs`` "eager" and its reason).  The training step's MoE call
  is both: the batched program, run eagerly on tensors that require
  grad;
* a call whose outermost level is a ``grad`` level over a ``vmap`` level
  (``vmap(grad(f))``) runs the per-element program eagerly on its leaves
  as they are, each op batching by its rule.

The refusals the reference keeps stand, each stated in ``bake_errors``: a
batched marshal source (``levels.per_element`` repacks it element by
element), a marshal source that requires grad (a plan hoists what
autograd would differentiate), and a ``scan_body`` entry.

**The CUDA graph.**  The capture reads the caller's own tensors at the
guarded positions, so the matrix is never copied per call.  A leaf the
program reads and no marshal guard covers is first captured in place too,
under a guard of the same kind; when a call brings another tensor there
(the CG's direction vector ``p`` does on every call) the plan re-captures
once with a static buffer at that position, which each later call fills
with one device copy.  A plan baked by ``LilacFunction.prewarm`` gets
static buffers at the positions of prewarm's throwaway zeros from its
first capture.  A leaf the program never reads (``row_ptr`` once its
anchor is replaced) is neither copied nor read.  Outputs are cloned out of
the graph's pool, which the next replay overwrites.  Each capture times
one call of the replay, copies included, against one eager run of the same
program, each to the end of its device work (:func:`per_call_ms`), and
keeps the graph only where it is the faster: a GNN step's operand and
output copies cost more than the host work the graph saves, so that plan
runs its program eagerly, still without the interpreter's fingerprints
and selection.  The kernels launch on
``torch.cuda.current_stream()``, which is the capture stream during
capture, and no harness body syncs.  The kernels' Python launch counters
(``kernels.common.COUNTERS``) count each replay's launches, as recorded at
capture; the launches of a capture and of its warm-up run are not counted,
so a count says how often calls of the program launched each kernel.

**Closure captures.**  A function that wraps a numpy array with
``torch.as_tensor`` traces to a ``_tensor_constant`` sharing the array's
memory, re-read on every interpreted call: a write to the array changes
the output, and no ``_version`` moves.  Every constant whose storage is
borrowed (not resizable: numpy, DLPack) therefore gets an exact content
guard, checked on every call; one above ``CONST_GUARD_MAX_BYTES`` refuses
to bake (pass such a matrix as an argument).  A closure-captured torch
tensor cannot reach a plan: tracing refuses it.

Not ported, with no counterpart here: ``donate_args`` (torch has no buffer
donation).  As in the reference, an entry that holds a ``scan_body``
rewrite never bakes and never persists a record (the pass manager keeps
it in memory and ``plan_info()["bake_errors"]`` says why).

Environment knobs:

  LILAC_TORCH_PLAN_CACHE          plan-cache file path
                                  (default ~/.cache/lilac-torch/plans.json)
  LILAC_TORCH_PLAN_CACHE_DISABLE  "1": never read or persist plans
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.fx import GraphModule, Node
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core import faults, levels
from repro_torch.core.jsonstore import JsonStore, cache_dir
from repro_torch.core.levels import grad_state
from repro_torch.core.marshal import (TrackedArray, checksum, fingerprint,
                                      has_version, unwrap, version_token)
from repro_torch.kernels.common import COUNTERS, differentiable_graph

SCHEMA_VERSION = 1
_ENV_PATH = "LILAC_TORCH_PLAN_CACHE"
_ENV_DISABLE = "LILAC_TORCH_PLAN_CACHE_DISABLE"

#: borrowed closure captures above this size refuse to bake: their guard
#: must hash exactly (the interpreter re-reads captures exactly), and exact
#: hashing per call would defeat the plan's purpose.
CONST_GUARD_MAX_BYTES = 1 << 20


class PlanBakeError(RuntimeError):
    """Baking failed (a capture the card refused, drifted marshal clauses,
    a capture past the guard bound).  The pass manager records it and
    stays on the interpreter."""


def default_plan_cache_path() -> Path:
    env = os.environ.get(_ENV_PATH)
    return Path(env) if env else cache_dir() / "plans.json"


def plan_cache_disabled() -> bool:
    return os.environ.get(_ENV_DISABLE, "") == "1"


_SHARED_CACHES: Dict[Tuple[str, str], "PlanCache"] = {}


def shared_plan_cache(path, registry_fingerprint: str) -> "PlanCache":
    """One PlanCache per (file, registry fingerprint) in a process, so the
    compiled functions share one view of the file.  ``path=None`` resolves
    the environment/default location."""
    key = (str(Path(path) if path is not None else default_plan_cache_path()),
           registry_fingerprint)
    pc = _SHARED_CACHES.get(key)
    if pc is None:
        pc = _SHARED_CACHES[key] = PlanCache(
            key[0], registry_fingerprint=registry_fingerprint)
    return pc


def reset_shared_plan_caches():
    """Drop the process-wide PlanCache views (a deleted or rewritten file
    is otherwise invisible to functions compiled later in the process)."""
    _SHARED_CACHES.clear()


# ---------------------------------------------------------------------------
# Match serialization: FX nodes <-> positional references
# ---------------------------------------------------------------------------
#
# A Match points into one traced GraphModule: its anchor, claimed nodes and
# binding values are Node objects.  The normalized graph of a program is
# deterministic, so every node has a stable address in graph order:
#
#   ["ph", i]     the i-th placeholder
#   ["ga", i]     the i-th get_attr node (a constant)
#   ["fn", i]     the i-th call_function node
#   ["pyint"/"pybool"/"pyfloat"/"pystr", v], ["none"]   literals by value
#
# Rehydration resolves the addresses against a freshly traced graph and
# checks the anchor's operator, so a stale or colliding record degrades to
# a cache miss (full detection), never to a wrong rewrite.

_OPS = {"placeholder": "ph", "get_attr": "ga", "call_function": "fn"}


def _node_tables(gm: GraphModule) -> Dict[str, List[Node]]:
    tables: Dict[str, List[Node]] = {t: [] for t in _OPS.values()}
    for n in gm.graph.nodes:
        tag = _OPS.get(n.op)
        if tag is not None:
            tables[tag].append(n)
    return tables


def _node_refs(tables) -> Dict[Node, Tuple[str, int]]:
    return {n: (tag, i) for tag, nodes in tables.items()
            for i, n in enumerate(nodes)}


def _ser_atom(v, ref) -> List:
    if isinstance(v, Node):
        r = ref.get(v)
        if r is None:
            raise PlanBakeError(f"binding node {v} has no stable address")
        return list(r)
    if isinstance(v, bool):
        return ["pybool", v]
    if isinstance(v, int):
        return ["pyint", int(v)]
    if isinstance(v, float):
        return ["pyfloat", float(v)]
    if isinstance(v, str):
        return ["pystr", v]
    if v is None:
        return ["none"]
    raise PlanBakeError(f"binding value {v!r} cannot be serialized")


def _de_atom(spec: Sequence, tables):
    tag = spec[0]
    if tag in ("ph", "ga", "fn"):
        return tables[tag][spec[1]]
    if tag == "pybool":
        return bool(spec[1])
    if tag == "pyint":
        return int(spec[1])
    if tag == "pyfloat":
        return float(spec[1])
    if tag == "pystr":
        return str(spec[1])
    if tag == "none":
        return None
    raise KeyError(f"unknown atom tag {tag!r}")


def _target_name(n: Node) -> str:
    return str(n.target)


def serialize_matches(gm: GraphModule, matches) -> List[Dict[str, Any]]:
    """JSON-able form of a detection report against ``gm``.  Raises
    :class:`PlanBakeError` when a match cannot be addressed."""
    ref = _node_refs(_node_tables(gm))
    out = []
    for m in matches:
        anchor = ref.get(m.anchor)
        if anchor is None or anchor[0] != "fn":
            raise PlanBakeError("anchor node not in the graph")
        out.append({
            "computation": m.computation,
            "variant": m.variant,
            "format": m.format,
            "epilogue": m.epilogue,
            "notes": m.notes,
            "anchor": anchor[1],
            "anchor_target": _target_name(m.anchor),
            "claimed": [ref[n][1] for n in m.claimed
                        if ref.get(n, ("",))[0] == "fn"],
            "binding": {k: _ser_atom(v, ref) for k, v in m.binding.items()},
        })
    return out


def detect_digest(serialized: List[Dict[str, Any]]) -> str:
    """Content digest of a serialized detection report (the integrity field
    of a plan-cache record)."""
    blob = json.dumps(serialized, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


def n_ops(gm: GraphModule) -> int:
    """The operator count a detection report carries (``n_eqns``)."""
    return sum(1 for n in gm.graph.nodes if n.op == "call_function")


def rehydrate_matches(gm: GraphModule, serialized) -> Optional[List[Any]]:
    """Resolve serialized matches against a freshly traced ``gm``; None
    (a cache miss) when anything fails to line up with the live graph."""
    from repro_torch.core.detect import Match

    tables = _node_tables(gm)
    fns = tables["fn"]
    try:
        out = []
        for rec in serialized:
            ai = rec["anchor"]
            if not 0 <= ai < len(fns):
                return None
            anchor = fns[ai]
            if _target_name(anchor) != rec["anchor_target"]:
                return None
            binding = {k: _de_atom(v, tables)
                       for k, v in rec["binding"].items()}
            claimed = tuple(fns[i] for i in rec.get("claimed", ())
                            if 0 <= i < len(fns))
            out.append(Match(
                computation=rec["computation"], variant=rec["variant"],
                format=rec["format"], anchor=anchor, binding=binding,
                notes=rec.get("notes", ""), claimed=claimed,
                epilogue=rec.get("epilogue")))
        return out
    except (KeyError, IndexError, TypeError, ValueError):
        return None


def _constants(gm: GraphModule) -> List[Tuple[str, Any]]:
    """(target, value) of every get_attr node, in graph order."""
    return [(n.target, getattr(gm, n.target)) for n in gm.graph.nodes
            if n.op == "get_attr"]


def plan_key(gm: GraphModule, platform: str, mode: str, policy: str,
             reuse: float = 100.0) -> str:
    """Cache key of one compiled signature: a hash of the normalized
    graph's code (a scan's body graph's too), each placeholder's and
    constant's shape and dtype, and the constants' fingerprints, qualified
    by platform, mode, policy and the declared marshal ``reuse`` (the
    tuner's amortized argmin depends on it).  The registry fingerprint is
    the file's header."""
    h = hashlib.blake2b(digest_size=16)
    _hash_graph(h, gm)
    return f"{h.hexdigest()}|{platform}|{mode}|{policy}|r{reuse:g}"


def _hash_graph(h, gm: GraphModule) -> None:
    h.update(gm.code.encode())
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            v = n.meta.get("val")
            h.update(repr((tuple(getattr(v, "shape", ())),
                           str(getattr(v, "dtype", type(v))))).encode())
    for target, c in _constants(gm):
        if isinstance(c, torch.Tensor):
            h.update(repr((target, tuple(c.shape), str(c.dtype),
                           fingerprint(c))).encode())
        elif isinstance(c, GraphModule):        # a scan's body
            h.update(target.encode())
            _hash_graph(h, c)


# ---------------------------------------------------------------------------
# Persistent plan cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheStats:
    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    stores: int = 0
    rejected: int = 0        # a record that failed rehydration
    invalidations: int = 0   # schema/registry-fingerprint drop
    save_errors: int = 0
    corrupt_recoveries: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class PlanCache(JsonStore):
    """Versioned JSON store of resolved plans, on the flat-keyed
    :class:`~repro_torch.core.jsonstore.JsonStore` protocol.

    Layout::

        {"schema": 1, "registry": "<fingerprint>",
         "entries": {"<graph-fp>|<platform>|<mode>|<policy>|r<reuse>": {
             "matches": [...], "pins": {"0": ["cuda.ell", null, null]},
             "n_eqns": 12, "detect_digest": "...", "joint": {...}}}}
    """

    schema_version = SCHEMA_VERSION

    def __init__(self, path: Optional[os.PathLike] = None,
                 registry_fingerprint: str = ""):
        self.stats = PlanCacheStats()   # before super(): the hooks need it
        super().__init__(path, registry_fingerprint)

    def default_path(self) -> Path:
        return default_plan_cache_path()

    def _note_invalidation(self):
        self.stats.invalidations += 1

    def _note_corrupt_recovery(self):
        self.stats.corrupt_recoveries += 1

    def _note_save_error(self):
        self.stats.save_errors += 1

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        rec = self.entries.get(key)
        if rec is None and not self.loaded:
            self.load()
            rec = self.entries.get(key)
            if rec is not None and "dropped" not in rec:
                self.stats.disk_hits += 1
                return rec
        elif rec is not None and "dropped" not in rec:
            self.stats.memory_hits += 1
            return rec
        self.stats.misses += 1
        return None

    def drop(self, key: str, reason: str) -> None:
        """Retire a record (a quarantine or a shadow divergence made its
        pins stale).  A tombstone takes its place, since a save merges the
        entries over the file's: ``get`` treats it as a miss, and the
        entry's next resolution persists over it."""
        if not self.loaded:
            self.load()
        if key in self.entries:
            self.put(key, {"dropped": str(reason)[:200]})

    def put(self, key: str, record: Dict[str, Any], persist: bool = True):
        self.entries[key] = record
        self.stats.stores += 1
        if persist:
            self.save()


# ---------------------------------------------------------------------------
# Recording: one interpreted call's selections and marshaled buffers
# ---------------------------------------------------------------------------

class _Slot:
    """What one match contributed during the recorded call."""
    __slots__ = ("harness", "schedule", "fuse", "buffers")

    def __init__(self):
        self.harness = None
        self.schedule = None
        self.fuse = None
        self.buffers: List[Any] = []


class PlanRecorder:
    """Observes one interpreted call: per match, the selected harness, its
    schedule and fusion decision, and the marshaled values its clauses
    produced, in clause order — everything baking needs."""

    def __init__(self):
        self.slots: Dict[int, _Slot] = {}

    def slot(self, m) -> _Slot:
        return self.slots.setdefault(id(m.anchor), _Slot())

    def begin(self, m, harness, schedule, fuse=None):
        """Called after selection: the tuner's candidate repacks may have
        gone through the recording cache, so the buffer list restarts here
        and records the winner's call only."""
        s = self.slot(m)
        s.harness = harness
        s.schedule = schedule
        s.fuse = fuse
        s.buffers.clear()

    def complete_for(self, matches) -> bool:
        return all((s := self.slots.get(id(m.anchor))) is not None
                   and s.harness is not None for m in matches)


class _RecordingCache:
    """Transparent recorder around a MarshalingCache (no ``ensure``)."""
    __slots__ = ("_inner", "_sink")

    def __init__(self, inner, sink: List[Any]):
        self._inner = inner
        self._sink = sink

    def get(self, name, keys, compute):
        val = self._inner.get(name, keys, compute)
        self._sink.append(val)
        return val

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _RecordingPlane(_RecordingCache):
    """Transparent recorder around a DataPlane (has ``ensure``)."""
    __slots__ = ()

    def ensure(self, src, dst, keys, binding, fallback=None):
        val = self._inner.ensure(src, dst, keys, binding, fallback=fallback)
        self._sink.append(val)
        return val


def recording_cache(inner, sink: List[Any]):
    """Wrap a call's marshaling cache so that the values it serves are
    recorded; None (``marshal_policy='off'``) stays None: every call
    repacks, and nothing may be hoisted."""
    if inner is None:
        return None
    if hasattr(inner, "ensure"):
        return _RecordingPlane(inner, sink)
    return _RecordingCache(inner, sink)


class _PlanBuffers:
    """The bake-time stand-in for the data plane: marshal clauses get the
    recorded buffers back, in clause order, and nothing is fingerprinted."""
    __slots__ = ("_vals", "_i")

    def __init__(self, values: Sequence[Any]):
        self._vals = tuple(values)
        self._i = 0

    def _next(self):
        if self._i >= len(self._vals):
            raise PlanBakeError(
                "marshal clause count drifted between record and bake")
        v = self._vals[self._i]
        self._i += 1
        return v

    def get(self, name, keys, compute):
        return self._next()

    def ensure(self, src, dst, keys, binding, fallback=None):
        return self._next()


# ---------------------------------------------------------------------------
# Guards and leaf templates
# ---------------------------------------------------------------------------

class _Guard:
    """One leaf guarded by :func:`version_token`, with a strong reference
    that keeps the token's storage identity (and, on the card, the
    captured address) valid.  A TrackedArray leaf is guarded by its own
    version and by its tensor's token.  A ``contents`` guard (a marshal
    source) holds a tensor without a version counter to its checksum too;
    an identity guard (a leaf a CUDA graph reads in place) needs only the
    address."""
    __slots__ = ("pos", "ref", "token", "contents")

    def __init__(self, pos: int, leaf, contents: bool = False):
        self.pos = pos
        self.contents = contents
        self.rebind(leaf)

    def _token(self, leaf):
        if isinstance(leaf, TrackedArray):
            return (version_token(leaf), version_token(leaf.arr))
        token = version_token(leaf)
        if (self.contents and isinstance(leaf, torch.Tensor)
                and not has_version(leaf)):
            return token + (checksum(leaf),)
        return token

    def rebind(self, leaf):
        self.ref = leaf
        self.token = self._token(leaf)

    def ok(self, leaf) -> bool:
        return self._token(leaf) == self.token


class _ConstGuard:
    """A borrowed closure capture, held to its exact bytes."""
    __slots__ = ("ref", "digest")

    def __init__(self, const: torch.Tensor):
        self.ref = const
        self.digest = fingerprint(const, exact=True)

    def ok(self) -> bool:
        return fingerprint(self.ref, exact=True) == self.digest


def leaf_templates(flat) -> Tuple:
    """The per-leaf keying shared by every dispatch layer: a tensor (or a
    TrackedArray's tensor) keys as ``("t", shape, dtype, device,
    grad_state)`` (``levels.grad_state``: ``requires_grad``, or the
    ``torch.func`` levels of a wrapped tensor); any
    other leaf by its type and value, since the trace bakes Python values
    into the graph.  The compile-dict key, the last-entry fast path and a
    plan's guard templates all derive from this function."""
    out = []
    for a in map(unwrap, flat):
        if isinstance(a, torch.Tensor):
            out.append(("t", tuple(a.shape), a.dtype, a.device,
                        grad_state(a)))
        else:
            out.append(("py", type(a), a))
    return tuple(out)


def leaves_match(templates: Tuple, flat) -> bool:
    """Compare live leaves against stored templates without building a new
    tuple: the last-entry fast path."""
    if len(templates) != len(flat):
        return False
    for t, a in zip(templates, map(unwrap, flat)):
        if t[0] == "t":
            if (not isinstance(a, torch.Tensor) or a.shape != t[1]
                    or a.dtype != t[2] or a.device != t[3]
                    or grad_state(a) != t[4]):
                return False
        elif type(a) is not t[1] or a != t[2]:
            return False
    return True


def plain_tensor(x) -> bool:
    """A tensor a plan may serve: a plain ``torch.Tensor`` (not fake, not
    functional, not a subclass, not a ``torch.func`` wrapper) that does not
    require grad."""
    return (type(x) is torch.Tensor and not x.requires_grad
            and not torch._is_functional_tensor(x)
            and not torch._C._functorch.is_functorch_wrapped_tensor(x))


def real_tensor(x) -> bool:
    """A tensor a plan under a transform may serve: below its
    ``torch.func`` levels a plain ``torch.Tensor`` (not fake, not
    functional, not a subclass; it may require grad), and no ambient trace
    records the call."""
    b = levels.base(x)
    return (type(b) is torch.Tensor and not torch._is_functional_tensor(b)
            and _get_current_dispatch_mode() is None)


def transformed(tensors) -> bool:
    """A call a plain plan cannot serve: a tensor carries a ``torch.func``
    level or requires grad."""
    return any(x.requires_grad or
               torch._C._functorch.is_functorch_wrapped_tensor(x)
               for x in tensors)


def _closure(gm: GraphModule, nodes) -> set:
    """``nodes`` and every node they transitively read."""
    need = set(nodes)
    for n in reversed(gm.graph.nodes):
        if n in need:
            need.update(n.all_input_nodes)
    return need


def _placeholder_index(gm: GraphModule) -> Dict[Node, int]:
    return {n: i for i, n in enumerate(
        n for n in gm.graph.nodes if n.op == "placeholder")}


def marshal_guard_positions(gm: GraphModule, match_harness_pairs) -> frozenset:
    """Placeholder positions whose contents the hoisted marshal buffers
    were derived from: the binding nodes each selected harness's marshal
    clauses key on, closed transitively back to the graph inputs.
    (Closure captures need no position: every borrowed constant has its
    own guard.)"""
    targets = set()
    for m, h in match_harness_pairs:
        for cl in getattr(h, "marshal", ()) or ():
            for alts in cl.keys:
                for k in alts:
                    v = m.binding.get(k)
                    if isinstance(v, Node):
                        targets.add(v)
                        break
    if not targets:
        return frozenset()
    index = _placeholder_index(gm)
    return frozenset(index[n] for n in _closure(gm, targets) if n in index)


def read_positions(gm: GraphModule, matches, needed) -> frozenset:
    """Placeholder positions the rewritten program may read: inputs of the
    operators it still runs, values any harness binding names, and graph
    outputs."""
    index = _placeholder_index(gm)
    read = set()
    for n in gm.graph.nodes:
        if n in needed or n.op == "output":
            read.update(n.all_input_nodes)
    for m in matches:
        read.update(v for v in m.binding.values() if isinstance(v, Node))
    return frozenset(index[n] for n in read if n in index)


def borrowed_constants(gm: GraphModule) -> List[torch.Tensor]:
    """The graph's tensor constants whose memory torch does not own (a
    storage that is not resizable: ``torch.as_tensor`` of a numpy array,
    DLPack): another owner may write them between calls."""
    return [c for _, c in _constants(gm) if isinstance(c, torch.Tensor)
            and not c.untyped_storage().resizable()]


def const_guards_for(gm: GraphModule) -> List[_ConstGuard]:
    consts = borrowed_constants(gm)
    big = [c for c in consts
           if c.numel() * c.element_size() > CONST_GUARD_MAX_BYTES]
    if big:
        raise PlanBakeError(
            f"borrowed closure capture of {big[0].numel() * big[0].element_size()}"
            f" bytes exceeds the exact-guard bound ({CONST_GUARD_MAX_BYTES}); "
            f"pass it to the function as a tensor argument to enable baking")
    return [_ConstGuard(c) for c in consts]


# ---------------------------------------------------------------------------
# Launch counts across a capture
# ---------------------------------------------------------------------------

def _launch_snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in COUNTERS]


def _launch_restore(snap) -> None:
    for c, s in zip(COUNTERS, snap):
        c.update(s)


def _launch_delta(before, after) -> List[Tuple[dict, str, int]]:
    return [(c, k, a[k] - b.get(k, 0)) for c, b, a in zip(COUNTERS, before,
                                                            after)
            for k in a if a[k] != b.get(k, 0)]


class _Capture:
    """The program captured in a ``torch.cuda.CUDAGraph`` on given
    arguments: ``static`` positions read private buffers, every other
    position the tensor it was captured on."""

    def __init__(self, runner: Callable, leaves: List[torch.Tensor],
                 static: frozenset):
        self.static = {i: leaves[i].clone() for i in sorted(static)}
        args = [self.static.get(i, t) for i, t in enumerate(leaves)]
        snap = _launch_snapshot()
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                runner(*args)           # warm-up, outside the capture
            torch.cuda.current_stream().wait_stream(side)
            before = _launch_snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outs = list(runner(*args))
            self.launches = _launch_delta(before, _launch_snapshot())
        except Exception as e:
            raise PlanBakeError(f"CUDA-graph capture failed: {e!r}") from e
        finally:
            _launch_restore(snap)

    def copy_bytes(self) -> int:
        """Bytes each replay copies: static inputs in, outputs out."""
        return sum(t.numel() * t.element_size()
                   for t in list(self.static.values()) + self.outs
                   if isinstance(t, torch.Tensor))

    def run(self, leaves) -> List[Any]:
        """One replay on ``leaves``, its launches not counted."""
        for i, buf in self.static.items():
            buf.copy_(leaves[i])
        self.graph.replay()
        return [o.clone() if isinstance(o, torch.Tensor) else o
                for o in self.outs]

    def replay(self, leaves) -> List[Any]:
        outs = self.run(leaves)
        for c, k, n in self.launches:
            c[k] += n
        return outs


def per_call_ms(*fns: Callable, calls: int = 8) -> List[float]:
    """For each of ``fns``, the least ms of one call timed to the end of
    its device work: host work and device work in series, so a CUDA
    graph's saved host work and its copies' device work both count.  The
    calls of the functions alternate."""
    best = [math.inf] * len(fns)
    for _ in range(calls):
        for j, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[j] = min(best[j], time.perf_counter() - t0)
    return [b * 1e3 for b in best]


# ---------------------------------------------------------------------------
# The plan itself
# ---------------------------------------------------------------------------

def _unfaulted(runner: Callable) -> Callable:
    """``runner`` with fault injection paused: a plan's program is the
    executable containment does not see (the JAX package's jitted plan),
    so faults fire at its bake (``bake_raise``), not in its calls."""
    def run(*leaves):
        if faults.ACTIVE is None:
            return runner(*leaves)
        with faults.paused():
            return runner(*leaves)
    return run


class ExecutablePlan:
    """A baked realization of one ``CompiledEntry``: the rewritten program
    (a CUDA graph on the card, the eager program on the CPU) and the guards
    that keep it honest.

    ``tensor_pos`` maps program inputs to flat-leaf positions; ``guards``
    are the marshal sources' (by flat position); ``pinned`` the program
    positions a CUDA graph reads in place without a marshal guard.

    A plan under transforms (:class:`Transform`) serves calls whose
    tensors carry ``torch.func`` levels or require grad: a batched one
    runs on the tensors below the call's ``vmap`` levels, which its
    ``structure`` guards, and a gradient-carrying one runs eagerly."""

    def __init__(self, runner, in_spec, out_spec, templates, tensor_pos,
                 guards, const_guards, report, selections, schedules, fuses,
                 hoisted, registry_epoch: int, platform: str,
                 read: frozenset = frozenset(),
                 transform: Optional["Transform"] = None):
        self.program = runner           # a GraphModule, or the interpreter
        self.runner = _unfaulted(runner)
        self.transform = transform
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.templates = templates
        self.tensor_pos = tuple(tensor_pos)
        self.guards = list(guards)
        self.const_guards = list(const_guards)
        self.report = report
        self.selections = selections
        self.schedules = schedules
        self.fuses = fuses
        self.hoisted = hoisted          # {id(anchor): (buffers...)}
        # the registry's epoch at bake time: any (re-)registration since
        # refuses the plan, so a replaced body never runs from a stale one
        self.registry_epoch = registry_epoch
        self.platform = platform
        self.hits = 0
        self.recaptures = 0
        self._capture: Optional[_Capture] = None
        self.copy_bytes = 0
        self.replay_ms: Optional[float] = None
        self.eager_ms: Optional[float] = None
        self._pinned: Dict[int, _Guard] = {}
        self._static: frozenset = frozenset()
        flat_guarded = {g.pos for g in self.guards}
        self._in_place = frozenset(
            i for i, p in enumerate(self.tensor_pos)
            if i in read and p not in flat_guarded)

    # -- dispatch ------------------------------------------------------------

    def fits(self, in_spec, flat) -> Optional[Tuple[List[torch.Tensor],
                                                    Tuple]]:
        """The tensors the program runs on and the ``vmap`` levels its
        outputs go back to (``levels.peel``), when the call has this plan's
        leaf templates and level structure, else None.  Reads no guard."""
        if in_spec != self.in_spec or not leaves_match(self.templates, flat):
            return None
        tensors = [unwrap(flat[p]) for p in self.tensor_pos]
        tf = self.transform
        if tf is None:
            return (tensors, ()) if all(map(plain_tensor, tensors)) else None
        if _get_current_dispatch_mode() is not None or not all(
                type(levels.base(t)) is torch.Tensor for t in tensors):
            return None
        if tf.structure is None:
            return tensors, ()
        peeled = levels.peel(tensors)
        if peeled.structure() != tf.structure:
            return None
        return peeled.tensors, peeled.levels

    def match(self, in_spec, flat) -> Optional[Tuple[List[torch.Tensor],
                                                     Tuple]]:
        """The per-call guard: :meth:`fits`' tensors and levels when this
        plan can serve the call, else None.  One loop over the arity."""
        got = self.fits(in_spec, flat)
        if got is None:
            return None
        for g in self.guards:
            if not g.ok(flat[g.pos]):
                return None
        for g in self.const_guards:
            if not g.ok():
                return None
        return got

    def run(self, tensors: List[torch.Tensor]) -> List[Any]:
        self.hits += 1
        moved = [i for i, g in self._pinned.items() if not g.ok(tensors[i])]
        if moved:
            # another tensor at a position read in place: give it a static
            # buffer (once), the other pinned positions stay in place
            with _outside_transforms(self.transform):
                self._recapture(tensors, self._static | frozenset(moved))
        if self._capture is None:
            return list(self.runner(*tensors))
        return self._capture.replay(tensors)

    # -- the CUDA graph ------------------------------------------------------

    def capture(self, tensors: List[torch.Tensor],
                static_leaves: frozenset = frozenset()) -> None:
        """Capture the program on the card (call once, after baking).  The
        flat leaf positions ``static_leaves`` hold throwaway tensors: those
        the program reads in place get static buffers at once."""
        static = frozenset(i for i in self._in_place
                           if self.tensor_pos[i] in static_leaves)
        self._recapture(tensors, self._static | static)
        self.recaptures = 0

    def _recapture(self, tensors, static: frozenset) -> None:
        self._capture = None            # free the old graph's pool first
        self._static = static
        self._pinned = {i: _Guard(i, tensors[i])
                        for i in self._in_place - static}
        capture = _Capture(self.runner, tensors, static)
        self.recaptures += 1
        self.copy_bytes = capture.copy_bytes()
        snap = _launch_snapshot()
        try:
            self.replay_ms, self.eager_ms = per_call_ms(
                lambda: capture.run(tensors), lambda: self.runner(*tensors))
        finally:
            _launch_restore(snap)
        if self.eager_ms < self.replay_ms:
            # the copies cost more than the host work the graph saves: run
            # the program eagerly (still with its hoisted buffers)
            self._pinned = {}
            return
        self._capture = capture

    # -- the plan's life cycle -----------------------------------------------

    def refresh_guards(self, raw_flat, tensors) -> None:
        """Re-anchor the guards on new, content-identical leaves (the data
        plane served the same buffers); a CUDA graph that read the old
        tensors in place is captured again on the new ones."""
        for g in self.guards:
            g.rebind(raw_flat[g.pos])
        if self._capture is not None:
            with _outside_transforms(self.transform):
                self._recapture(tensors, self._static)

    def consts_ok(self) -> bool:
        """True while no guarded closure capture has changed: a changed
        one means the program itself is stale, so the plan must re-bake
        rather than re-anchor its guards."""
        return all(g.ok() for g in self.const_guards)

    def same_hoisted(self, recorder: PlanRecorder) -> bool:
        """True when a recorded call produced exactly the buffers this
        plan hoisted (object identity: data-plane hits return the cached
        objects)."""
        for aid, bufs in self.hoisted.items():
            s = recorder.slots.get(aid)
            if s is None or len(s.buffers) != len(bufs):
                return False
            if any(a is not b for a, b in zip(s.buffers, bufs)):
                return False
        return True

    def hoisted_nbytes(self) -> int:
        """Bytes of the marshaled layouts this plan pins."""
        total = 0
        for bufs in self.hoisted.values():
            for b in bufs:
                for f in (dataclasses.fields(b)
                          if dataclasses.is_dataclass(b) else ()):
                    v = getattr(b, f.name)
                    if isinstance(v, torch.Tensor):
                        total += v.numel() * v.element_size()
                if isinstance(b, torch.Tensor):
                    total += b.numel() * b.element_size()
        return total

    def release(self) -> None:
        """Let go of the CUDA graph (its memory pool and static buffers)
        and of the hoisted layouts: a dropped plan must not pin them until
        the garbage collector runs."""
        self._capture = None
        self._pinned = {}
        self.hoisted = {}
        if self.platform == "cuda":
            torch.cuda.empty_cache()

    def _eager_reason(self) -> Optional[str]:
        if self._capture is not None:
            return None
        if self.transform is not None and self.transform.eager is not None:
            return self.transform.eager
        if self.platform != "cuda":
            return "the CPU runs the program eagerly"
        return "the CUDA graph's copies cost more than the host work it " \
               "saves (replay_ms > eager_ms)"

    def describe(self) -> Dict[str, Any]:
        """JSON-able summary (``plan_info``)."""
        return {
            "arity": len(self.templates),
            "tensor_leaves": [[list(t[1]), str(t[2])]
                              for t in self.templates if t[0] == "t"],
            "selections": [name for _, name in self.selections],
            "schedules": list(self.schedules),
            "fuses": list(self.fuses),
            "guards": len(self.guards),
            "const_guards": len(self.const_guards),
            "hoisted_nbytes": self.hoisted_nbytes(),
            "transform": None if self.transform is None
            else self.transform.describe(),
            "runs": "cuda_graph" if self._capture is not None else "eager",
            "eager_reason": self._eager_reason(),
            "cuda_graph": self._capture is not None,
            "graph_copy_bytes": self.copy_bytes,
            "replay_ms": self.replay_ms,
            "eager_ms": self.eager_ms,
            "static_inputs": sorted(self._static),
            "in_place_inputs": sorted(self._pinned),
            "recaptures": self.recaptures,
            "hits": self.hits,
        }


class Transform:
    """What a plan under transforms serves (:func:`transform_for`).

    ``structure``: the peeled ``vmap`` levels' batch sizes and batch dims
    and the shapes and strides below them (``levels.Peeled.structure``),
    None when the program runs on the leaves as they are; ``grad``: the
    call carries gradients; ``eager``: why the program runs eagerly (None:
    it may take a CUDA graph).  It holds no tensor of the call."""
    __slots__ = ("structure", "grad", "eager")

    def __init__(self, structure, grad: bool, eager: Optional[str]):
        self.structure = structure
        self.grad = grad
        self.eager = eager

    def describe(self) -> Dict[str, Any]:
        return {"vmap": [] if self.structure is None
                else [[b, list(d)] for b, d in self.structure[0]],
                "grad": self.grad}


def transform_for(tensors) -> Tuple[Optional[Transform],
                                     Optional[levels.Peeled]]:
    """The transform a call on ``tensors`` stands under (None for plain
    tensors), and the call's tensors below its peeled ``vmap`` levels.
    The outermost ``vmap`` levels are peeled where the tensors below carry
    no ``vmap`` level of their own; otherwise (a ``grad`` level over a
    ``vmap`` one) the per-element program runs on the leaves as they
    are, and nothing is peeled."""
    if not transformed(tensors):
        return None, None
    grad = any(map(levels.requires_grad, tensors))
    peeled = levels.peel(tensors)
    if not peeled.levels or any(map(levels.batched, peeled.tensors)):
        peeled = None
    if grad:
        eager = ("carries gradients: a CUDA-graph replay records no "
                 "autograd graph, so the program runs eagerly")
    elif peeled is None or any(map(torch._C._functorch.
                                   is_functorch_wrapped_tensor,
                                   peeled.tensors)):
        eager = ("the call's tensors keep a torch.func level: the "
                 "program runs eagerly on them")
    else:
        eager = None
    return Transform(None if peeled is None else peeled.structure(), grad,
                     eager), peeled


def batched_program(runner: Callable, peeled: levels.Peeled,
                    grad: bool) -> GraphModule:
    """``make_fx`` of ``torch.func.vmap`` of the per-element ``runner``
    over the peeled levels (``levels.program``), traced once on fakes of
    the tensors below the levels, outside the caller's transforms: each
    custom op batches by its vmap rule into one node (one launch for the
    batch), the hoisted buffers become the graph's constants.  A program
    for calls that carry gradients calls the ops' differentiable forms
    (``kernels.common.differentiable_graph``)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.detect import normalize_graph, own_trace

    run = _unfaulted(runner)
    prog = levels.program(lambda *t: list(run(*t)), peeled.levels)
    try:
        with own_trace():   # no op here may lift a tensor to a caller's level
            bases = [levels.base(t).detach() for t in peeled.tensors]
            gm = make_fx(prog, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*bases)
    except Exception as e:
        raise PlanBakeError(f"the batched program did not trace: {e!r}") \
            from e
    gm = normalize_graph(gm)
    return differentiable_graph(gm) if grad else gm


def _program(runner: Callable, tf: Optional[Transform],
             peeled: Optional[levels.Peeled]) -> Callable:
    """The program a plan runs: ``runner`` itself, its batched form, or
    (for calls that carry gradients) its graph with the custom ops'
    differentiable calls."""
    if tf is None:
        return runner
    if peeled is not None:
        return batched_program(runner, peeled, tf.grad)
    if tf.grad and isinstance(runner, GraphModule):
        return differentiable_graph(runner)
    return runner


def _refuse_marshal_sources(raw_flat, tensor_pos, guard_pos) -> None:
    """The refusals the reference keeps: a plan guards and hoists a
    marshal source's contents, so a batched one (repacked element by
    element) or one that requires grad (which autograd differentiates)
    never bakes."""
    for i in sorted(guard_pos):
        leaf = unwrap(raw_flat[tensor_pos[i]])
        if levels.batched(leaf):
            raise PlanBakeError(
                "vmapped call with a batched marshal source (the matrix "
                "carries a torch.func.vmap level): levels.per_element "
                "repacks and launches once an element, and a plan cannot "
                "hoist or guard the elements' layouts; never a plan")
        if levels.requires_grad(leaf):
            raise PlanBakeError(
                "carries gradients into a marshal source (the matrix's "
                "values require grad): a plan would hoist what autograd "
                "differentiates; runs the interpreter, never a plan")


def _finish(plan: ExecutablePlan, tensors,
            static_leaves: frozenset) -> ExecutablePlan:
    tf = plan.transform
    if plan.platform == "cuda" and (tf is None or tf.eager is None):
        with _outside_transforms(tf):
            plan.capture(tensors, static_leaves)
    return plan


def _outside_transforms(tf):
    """The caller's ``torch.func`` levels set aside while a batched plan
    captures its program on the tensors below them."""
    import contextlib

    if tf is None:
        return contextlib.nullcontext()
    from repro_torch.core.detect import own_trace
    return own_trace()


def bake_plan(*, gm: GraphModule, matches, needed, recorder: PlanRecorder,
              raw_flat, tensors, tensor_pos, in_spec, out_spec, report,
              mode: str, platform: str, registry_epoch: int = 0,
              static_leaves: frozenset = frozenset()) -> ExecutablePlan:
    """Bake one resolved host-mode rewrite into an :class:`ExecutablePlan`.

    ``raw_flat`` are the call's leaves as passed (possibly TrackedArray),
    ``tensors`` the unwrapped tensors the program runs on, taken from the
    flat positions ``tensor_pos``.  Raises :class:`PlanBakeError` (or what
    the capture raises) on failure; the caller decides what to do.
    ``static_leaves``: flat positions whose tensors no later call brings
    again (``ExecutablePlan.capture``)."""
    from repro_torch.core.harness import CallCtx
    from repro_torch.core.rewrite import run_rewritten

    if faults.ACTIVE is not None:
        faults.fail("bake_raise", "bake")
    if not recorder.complete_for(matches):
        raise PlanBakeError("recorded call is missing selections")
    slots = {id(m.anchor): recorder.slots[id(m.anchor)] for m in matches}
    guard_pos = marshal_guard_positions(
        gm, [(m, slots[id(m.anchor)].harness) for m in matches])
    tf, peeled = transform_for(tensors)
    if tf is not None:
        _refuse_marshal_sources(raw_flat, tensor_pos, guard_pos)
    const_guards = const_guards_for(gm)
    grad = tf is not None and tf.grad

    def select(m, binding=None, ctx=None):
        s = slots[id(m.anchor)]
        if ctx is not None:
            ctx.schedule = s.schedule
            ctx.fuse = s.fuse
        return s.harness

    def ctx_factory(m):
        s = slots[id(m.anchor)]
        return CallCtx(mode=mode, cache=_PlanBuffers(s.buffers),
                       format=m.format, platform=platform,
                       schedule=s.schedule, epilogue=m.epilogue, fuse=s.fuse,
                       differentiable=grad)

    def runner(*leaves):
        return run_rewritten(gm, matches, select, list(leaves), ctx_factory,
                             needed=needed)

    program = _program(runner, tf, peeled)
    read = read_positions(gm, matches, needed) if peeled is None \
        else _graph_reads(program)
    plan = ExecutablePlan(
        program, in_spec, out_spec, leaf_templates(raw_flat), tensor_pos,
        [_Guard(tensor_pos[i], raw_flat[tensor_pos[i]], contents=True)
         for i in sorted(guard_pos)],
        const_guards, report,
        [(m, slots[id(m.anchor)].harness.name) for m in matches],
        [slots[id(m.anchor)].schedule for m in matches],
        [slots[id(m.anchor)].fuse for m in matches],
        {aid: tuple(s.buffers) for aid, s in slots.items()},
        registry_epoch, platform, read=read, transform=tf)
    return _finish(plan, tensors if peeled is None else peeled.tensors,
                   static_leaves)


def _graph_reads(gm: GraphModule) -> frozenset:
    return read_positions(gm, [], frozenset(
        n for n in gm.graph.nodes if n.op == "call_function"))


def bake_graph_plan(*, gm: GraphModule, raw_flat, tensors, tensor_pos,
                    in_spec, out_spec, report, selections, schedules, fuses,
                    platform: str, registry_epoch: int = 0,
                    static_leaves: frozenset = frozenset()) -> ExecutablePlan:
    """Bake a trace-mode entry: its rewritten ``GraphModule`` is the
    program (no marshaling, so no marshal guards)."""
    if faults.ACTIVE is not None:
        faults.fail("bake_raise", "bake")
    tf, peeled = transform_for(tensors)
    program = _program(gm, tf, peeled)
    plan = ExecutablePlan(
        program, in_spec, out_spec, leaf_templates(raw_flat), tensor_pos, [],
        const_guards_for(gm), report, selections, schedules, fuses, {},
        registry_epoch, platform, read=_graph_reads(program), transform=tf)
    return _finish(plan, tensors if peeled is None else peeled.tensors,
                   static_leaves)
