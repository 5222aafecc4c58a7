"""LiLAC-How data plane: formats, conversion planning, invariant caching
(paper §3.3.2, §4.2, Fig. 8/9/10/18).

Counterpart of ``repro.core.marshal``.  The paper tracks writes to host
arrays with memory protection so that device transfers and data-dependent
invariants are recomputed only when the memory changed; here "did this
matrix change?" is answered with content fingerprints at the harness call,
and, for a tensor the data plane has seen before, with its version.

* ``fingerprint(t)`` — cheap content hash: full bytes below a threshold,
  else a strided sample of ~1.2 k elements taken on the tensor's own
  device, so only the sample crosses to the host.
* ``SparseFormat`` / ``FORMATS`` — the format names marshal clauses use.
* ``ConversionGraph`` / ``GRAPH`` — repack functions as edges with
  measured (EWMA) costs; ``plan`` picks the cheapest path from any cached
  intermediate to the requested format, never through ``DENSE`` (see
  ``NO_TRANSIT``).
* ``MarshalingCache`` — memoizes derived values keyed on the fingerprints
  of their source arrays, least recently used out first.
* ``DataPlane`` — ``ensure(src, dst, ...)`` walks the conversion graph, so
  harnesses targeting one format share one cached buffer;
  ``estimate_marshal_seconds`` is what the autotuner amortizes.
* ``MarshalPolicy`` — the data plane's knobs: the declared call frequency
  ``reuse``, the capacity ``max_entries``, and ``enabled``.
* ``TrackedArray`` / ``version_token`` — the O(1) change tokens that the
  executable plans (:mod:`repro_torch.core.plan`) guard their operands by.
* ``ReadObject`` — a harness's own derived value (construct / update /
  destruct on a fingerprint change, the paper's Fig. 14), kept in its
  persistent state.

**Versions.**  A sampled fingerprint cannot see a write to one element off
its sample grid, and torch tensors, unlike the reference's JAX arrays, are
mutable.  Each group of cache entries derived from one matrix therefore
records, per key tensor, a :func:`checksum` of the bytes it was built from
and the ``(storage, _version)`` at each address it has served (a few
addresses each).  Every in-place torch operation bumps the tensor's
``_version`` (shared with its views), so a lookup whose fingerprint
matches is decided in O(1) for a tensor at a served address: the same
version hits, another is a miss that re-marshals.  A tensor at an address
the group has not served (a re-upload, or a new tensor where a freed one
lay) is decided by its checksum, one pass on its own device: the same
bytes share the buffers, other bytes re-marshal.  A tensor with no version
counter (one made under ``torch.inference_mode``) is keyed by its exact
bytes instead.  What ``_version`` cannot see is a write that bypasses
torch's in-place operators: through ``.data``, through a DLPack or
``.numpy()`` view of the memory, or by a kernel outside torch.  After such
a write the caller declares it by passing the matrix as a ``TrackedArray``
and calling ``replace`` with the new contents (the same tensor is fine):
``replace`` bumps the tensor's version, which every layer then sees.

Constructors hand back tensors on the device of their input, so a marshaled
format built from CUDA operands stays on the card between calls.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import faults

_SMALL = 1 << 16  # full-hash threshold in bytes

_MISSING = object()


def fingerprint(arr: Any, exact: bool = False) -> Tuple:
    """Content fingerprint of a tensor (or Python scalar; a TrackedArray
    gives its O(1) version token)."""
    if isinstance(arr, TrackedArray):
        return version_token(arr)
    if isinstance(arr, (int, float, bool)):
        return ("scalar", arr)
    t = arr.detach()
    meta = (tuple(t.shape), str(t.dtype), t.device.type)
    if exact or nbytes_of(t) <= _SMALL:
        data = t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        return ("full", meta,
                hashlib.blake2b(data.tobytes(), digest_size=16).hexdigest())
    # strided sample + edges, gathered on the device: cheap, catches
    # structural changes; callers that need exactness pass exact=True
    flat = t.reshape(-1)
    step = max(1, flat.shape[0] // 1024)
    sample = torch.cat([flat[::step][:1024], flat[:64], flat[-64:]])
    data = sample.cpu().view(torch.uint8).numpy()
    return ("sampled", meta,
            hashlib.blake2b(data.tobytes(), digest_size=16).hexdigest())


class TrackedArray:
    """Explicit-version wrapper: ``replace`` declares new contents and
    bumps the version, so a plan guards the operand in O(1).  ``arr`` is
    the current tensor.  ``replace`` also bumps the tensor's own
    ``_version`` (``torch.autograd.graph.increment_version``), so the data
    plane sees the write even when the new contents are the old tensor
    written outside torch's in-place operators."""

    def __init__(self, arr, base_token: Optional[object] = None,
                 version: int = 0):
        self.arr = arr
        self.base_token = base_token if base_token is not None else object()
        self.version = version

    def replace(self, new_arr) -> "TrackedArray":
        if isinstance(new_arr, torch.Tensor) and has_version(new_arr):
            torch.autograd.graph.increment_version(new_arr)
        return TrackedArray(new_arr, self.base_token, self.version + 1)

    def __repr__(self):
        return f"TrackedArray(v{self.version}, {tuple(getattr(self.arr, 'shape', ()))})"


def unwrap(x):
    return x.arr if isinstance(x, TrackedArray) else x


def has_version(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a version counter (an inference tensor does
    not)."""
    return not t.is_inference()


def tensor_token(t: torch.Tensor) -> Tuple:
    """O(1) identity and version of a tensor's contents: its storage, the
    view's place in it, its dtype and device, and its ``_version``.  Equal
    tokens of a tensor kept alive mean equal contents, save for a write
    ``_version`` cannot see (the module docstring)."""
    return ("tensor", id(t.untyped_storage()), t.data_ptr(),
            t.storage_offset(), tuple(t.shape), t.stride(), t.dtype,
            t.device, t._version if has_version(t) else None)


def version_token(x) -> Tuple:
    """O(1) change token for executable-plan guards
    (:mod:`repro_torch.core.plan`): a TrackedArray yields its (base-token
    id, version) pair, a tensor its :func:`tensor_token`, anything else its
    object identity.  Unlike :func:`fingerprint`, no bytes are read."""
    if isinstance(x, TrackedArray):
        return ("tracked", id(x.base_token), x.version)
    if isinstance(x, torch.Tensor):
        return tensor_token(x)
    return ("id", id(x))


def stamp(x) -> Optional[Tuple[int, int]]:
    """``(data_ptr, _version)`` of a key tensor with a version counter;
    None for anything else."""
    if isinstance(x, torch.Tensor) and has_version(x):
        return (x.data_ptr(), x._version)
    return None


#: int32 words a checksum pass reads at once (bounds its temporaries)
_CHECK_CHUNK = 1 << 24
#: odd multiplier of the checksum's position weights (2^64 / phi, signed)
_CHECK_MIX = -7046029254386353131


def checksum(t: torch.Tensor) -> int:
    """A 64-bit position-weighted sum of ``t``'s bytes, taken on its own
    device, so one scalar crosses to the host.  Each 32-bit word is
    weighted by an odd number, so a change to any one word always changes
    the sum; a wider change goes unseen only if its weighted differences
    cancel modulo 2^64."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    words = b.view(torch.int32)
    acc = torch.zeros((), dtype=torch.int64, device=words.device)
    for s in range(0, words.numel(), _CHECK_CHUNK):
        x = words[s:s + _CHECK_CHUNK].to(torch.int64)
        i = torch.arange(s, s + x.numel(), dtype=torch.int64,
                         device=words.device)
        acc += (x * ((i * _CHECK_MIX) | 1)).sum()
    return int(acc)


#: addresses a group of cache entries remembers per key tensor
_STAMP_ADDRESSES = 8


class _Sources:
    """What a group of cache entries knows of the key tensors it was built
    from: per key, the checksum of their bytes and, at each address it has
    served, the storage (weakly) and the version seen there."""
    __slots__ = ("sums", "seen")

    def __init__(self, key_arrays: Sequence):
        self.sums = tuple(checksum(a) if stamp(a) is not None else None
                          for a in key_arrays)
        self.seen: Tuple[Dict[int, Tuple[int, Any]], ...] = tuple(
            {} for _ in key_arrays)
        self._note(key_arrays)

    def confirm(self, key_arrays: Sequence) -> bool:
        """Whether the key tensors hold the bytes the group was built from:
        by version at a served address (another version: written in place
        since), by checksum anywhere else.  Remembers them on success."""
        if len(key_arrays) != len(self.sums):
            return False
        for seen, s, a in zip(self.seen, self.sums, key_arrays):
            if stamp(a) is None:
                continue                # keyed exactly, or not a tensor
            rec = seen.get(a.data_ptr())
            if rec is not None and rec[1]() is a.untyped_storage():
                if rec[0] != a._version:
                    return False
            elif s is None or checksum(a) != s:
                return False
        self._note(key_arrays)
        return True

    def _note(self, key_arrays: Sequence) -> None:
        for seen, a in zip(self.seen, key_arrays):
            if stamp(a) is None:
                continue
            ptr = a.data_ptr()
            seen.pop(ptr, None)
            seen[ptr] = (a._version, weakref.ref(a.untyped_storage()))
            while len(seen) > _STAMP_ADDRESSES:
                del seen[next(iter(seen))]


def _group(key: Tuple) -> Tuple:
    """The entries one matrix's sources cover: a data-plane node's key
    without its format (the conversion graph's intermediates of one
    matrix), any other key by itself."""
    if key and key[0] == "node":
        return key[:2] + key[3:]
    return key


def key_fingerprint(a) -> Tuple:
    """The fingerprint a cache keys ``a`` by: sampled for a versioned
    tensor (its version and checksum decide a match, :class:`_Sources`),
    exact for a tensor without a version counter."""
    if isinstance(a, torch.Tensor) and not has_version(a):
        return fingerprint(a, exact=True)
    return fingerprint(a)


def nbytes_of(x) -> int:
    """Size of a tensor from its metadata; 0 for scalars and None."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def tree_nbytes(val) -> int:
    """``nbytes_of`` summed over a container of tensors (marshaled values
    are often tuples of buffers — ELL/BCSR packs)."""
    if isinstance(val, (tuple, list)):
        return sum(tree_nbytes(v) for v in val)
    if isinstance(val, dict):
        return sum(tree_nbytes(v) for v in val.values())
    return nbytes_of(val)


# ---------------------------------------------------------------------------
# Format registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseFormat:
    """A first-class storage format marshal clauses can name."""
    name: str
    description: str = ""


FORMATS: Dict[str, SparseFormat] = {}


def register_format(fmt: SparseFormat, override: bool = False) -> SparseFormat:
    if fmt.name in FORMATS and FORMATS[fmt.name] != fmt and not override:
        raise ValueError(f"format {fmt.name!r} already registered")
    FORMATS[fmt.name] = fmt
    return fmt


# Built-in format vocabulary, under the JAX package's names.
for _f in (
    SparseFormat("CSR", "val/col_ind/row_ptr (paper Fig. 4)"),
    SparseFormat("COO", "val/row/col triplets"),
    SparseFormat("DENSE", "densified matrix"),
    SparseFormat("ELL8", "row-padded slabs, lane=8"),
    SparseFormat("ELL128", "lane-128 ELL, kept as its slab-compacted "
                           "column-window layout"),
    SparseFormat("BCSR8x128", "block CSR, (8,128) tiles"),
    SparseFormat("BCSR128x128", "block CSR, (128,128) tiles, packed: "
                                "each tile's entries only"),
    SparseFormat("JDS", "jagged diagonal storage (paper Fig. 5)"),
):
    register_format(_f)


#: Formats a conversion path may end at, or start from when a source
#: loader produces them, but never pass through or start from as a cached
#: intermediate.  The reference routes CSR -> BCSR through DENSE so that
#: the BCSR repack can ride a densified matrix another harness cached; at
#: HPCG's 1.1 M rows that matrix would take ~5 TB, so here CSR -> BCSR is a
#: direct edge and DENSE -> BCSR serves only a source that is dense.
NO_TRANSIT = frozenset({"DENSE"})


# ---------------------------------------------------------------------------
# Conversion graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConversionEdge:
    """One repack ``src-format value -> dst-format value`` with a measured
    cost (EWMA of observed seconds; ``est_cost`` before the first run)."""
    src: str
    dst: str
    fn: Callable[[Any], Any]
    name: str
    est_cost: float = 1.0
    measured: Optional[float] = None
    last: Optional[float] = None   # seconds of the most recent run
    runs: int = 0

    def cost(self) -> float:
        return self.measured if self.measured is not None else self.est_cost

    def run(self, value) -> Tuple[Any, float]:
        out, dt = _timed(lambda: self.fn(value))
        self.measured = dt if self.measured is None \
            else 0.7 * self.measured + 0.3 * dt
        self.last = dt
        self.runs += 1
        return out, dt


def _timed(thunk: Callable[[], Any]) -> Tuple[Any, float]:
    """``thunk()`` and its seconds, to the end of the device work it queued
    (a repack on the card runs asynchronously)."""
    t0 = time.perf_counter()
    out = thunk()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class ConversionGraph:
    """Cost-weighted directed graph over format names; ``plan`` picks the
    cheapest conversion path, possibly through a cached intermediate."""

    def __init__(self):
        self._edges: Dict[str, List[ConversionEdge]] = {}

    def add(self, edge: ConversionEdge, override: bool = False) -> ConversionEdge:
        outs = self._edges.setdefault(edge.src, [])
        for i, e in enumerate(outs):
            if e.dst == edge.dst:
                if not override:
                    raise ValueError(
                        f"edge {edge.src}->{edge.dst} already registered")
                outs[i] = edge
                return edge
        outs.append(edge)
        return edge

    def plan(self, starts: Dict[str, float], dst: str
             ) -> Optional[Tuple[str, List[ConversionEdge], float]]:
        """Dijkstra from a set of start formats (each with an entry cost —
        0.0 for cached intermediates, the loader estimate for the source)
        to ``dst``, never leaving a ``NO_TRANSIT`` format that is not a
        start.  Returns (chosen start, edge path, total cost)."""
        if dst in starts:
            return dst, [], starts[dst]
        best: Dict[str, float] = dict(starts)
        back: Dict[str, Tuple[Optional[str], Optional[ConversionEdge]]] = {
            s: (None, None) for s in starts}
        counter = itertools.count()
        heap = [(c, next(counter), s) for s, c in starts.items()]
        heapq.heapify(heap)
        seen = set()
        while heap:
            cost, _, node = heapq.heappop(heap)
            if node in seen:
                continue
            seen.add(node)
            if node == dst:
                break
            if node in NO_TRANSIT and node not in starts:
                continue
            for e in self._edges.get(node, []):
                nc = cost + max(e.cost(), 0.0)
                if e.dst not in best or nc < best[e.dst]:
                    best[e.dst] = nc
                    back[e.dst] = (node, e)
                    heapq.heappush(heap, (nc, next(counter), e.dst))
        if dst not in back:
            return None
        path: List[ConversionEdge] = []
        node = dst
        while True:
            prev, edge = back[node]
            if edge is None:
                start = node
                break
            path.append(edge)
            node = prev
        path.reverse()
        return start, path, best[dst]

    def plan_cost(self, starts: Dict[str, float], dst: str
                  ) -> Optional[Tuple[float, Tuple[str, ...]]]:
        """The joint plan search's cost oracle
        (:mod:`repro_torch.core.plan_search`): the cheapest cost from any
        start format (each with its entry cost, 0.0 for one already built)
        to ``dst`` and the formats the path materializes.  Runs no edge."""
        plan = self.plan(dict(starts), dst)
        if plan is None:
            return None
        start, path, cost = plan
        return cost, (start,) + tuple(e.dst for e in path)

    def full_path_cost(self, src_fmt: str, dst: str,
                       entry_cost: float = 0.0) -> Optional[float]:
        """Cheapest-path cost src->dst, ignoring cached intermediates."""
        plan = self.plan({src_fmt: entry_cost}, dst)
        return None if plan is None else plan[2]


GRAPH = ConversionGraph()


def edge(src: str, dst: str, *, name: Optional[str] = None,
         est_cost: float = 1.0, override: bool = False):
    """Decorator: register a value-level conversion as an edge of GRAPH."""
    def deco(fn):
        GRAPH.add(
            ConversionEdge(src, dst, fn, name or f"{src}->{dst}",
                           est_cost=est_cost), override=override)
        return fn
    return deco


@dataclasses.dataclass
class SourceLoader:
    """How a marshal clause's *source* format is materialized from a
    harness binding (keyed by the clause's ``from`` name)."""
    name: str
    fmt: str
    fn: Callable[[Dict[str, Any]], Any]
    measured: Optional[float] = None
    last: Optional[float] = None

    def cost(self) -> float:
        return self.measured if self.measured is not None else 0.1

    def run(self, binding) -> Tuple[Any, float]:
        out, dt = _timed(lambda: self.fn(binding))
        self.measured = dt if self.measured is None \
            else 0.7 * self.measured + 0.3 * dt
        self.last = dt
        return out, dt


SOURCES: Dict[str, SourceLoader] = {}


def register_source(name: str, fmt: str, fn: Callable, override: bool = False
                    ) -> SourceLoader:
    if fmt not in FORMATS:
        raise ValueError(f"source {name!r} produces unknown format {fmt!r}")
    if name in SOURCES and not override:
        raise ValueError(f"source loader {name!r} already registered")
    loader = SourceLoader(name, fmt, fn)
    SOURCES[name] = loader
    return loader


# ---------------------------------------------------------------------------
# Policy and stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MarshalPolicy:
    """Knobs for the data plane (``compile(..., marshal_policy=)``).

    ``reuse``        declared call frequency: expected harness calls per
                     matrix change.  The autotuner folds repack cost in at
                     this rate (amortized cost = kernel + marshal / reuse).
    ``max_entries``  data-plane capacity; least recently used out first.
    ``enabled``      False: no data plane, every call repacks (the paper's
                     "naive library call").
    """
    reuse: float = 100.0
    max_entries: int = 64
    enabled: bool = True

    @staticmethod
    def parse(val) -> "MarshalPolicy":
        if val is None:
            return MarshalPolicy()
        if isinstance(val, MarshalPolicy):
            return val
        if isinstance(val, str):
            if val in ("shared", "default", "on"):
                return MarshalPolicy()
            if val in ("off", "none", "disabled"):
                return MarshalPolicy(enabled=False)
            raise ValueError(f"unknown marshal_policy {val!r} (use 'shared' "
                             f"| 'off' or a MarshalPolicy instance)")
        raise TypeError(f"marshal_policy must be str or MarshalPolicy, got "
                        f"{type(val).__name__}")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    bytes_avoided: int = 0
    recompute_seconds_avoided: float = 0.0
    edge_runs: int = 0          # conversion-graph edges executed
    loader_runs: int = 0        # binding->format source loads executed
    shared_edge_hits: int = 0   # paths that started from a cached
                                # intermediate instead of the binding
    evictions: int = 0
    stale: int = 0              # fingerprint hits whose key tensor was
                                # written in place since: re-marshaled


@dataclasses.dataclass
class PlanStats:
    """Per-(source, target-format) cache accounting."""
    src: str
    dst: str
    hits: int = 0
    misses: int = 0
    bytes_avoided: int = 0
    seconds_avoided: float = 0.0
    build_seconds: float = 0.0
    last_path: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# The caches
# ---------------------------------------------------------------------------

class MarshalingCache:
    """Memoizes marshaled INPUTs (paper Fig. 8/9/10), at most
    ``max_entries`` of them: the least recently used goes first."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._store: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._cost: Dict[Tuple, float] = {}
        # _group(key) -> what the group's entries were built from
        self._sources: Dict[Tuple, _Sources] = {}
        self._spec_cost: Dict[str, float] = {}   # repack -> last seconds
        self.stats = CacheStats()

    def _key(self, spec_name: str, key_arrays: Sequence) -> Tuple:
        return (spec_name,) + tuple(key_fingerprint(a) for a in key_arrays)

    def _lookup(self, key: Tuple, key_arrays: Sequence):
        """The entry under ``key``, or ``_MISSING`` when there is none or
        the key tensors do not hold the bytes it was built from (written in
        place since, or another tensor whose sample matches: then the
        group's entries are dropped)."""
        val = self._store.get(key, _MISSING)
        if val is _MISSING:
            return val
        group = _group(key)
        src = self._sources.get(group)
        if src is not None and not src.confirm(key_arrays):
            # every entry derived from the matrix is stale: the conversion
            # graph's intermediates too
            self.stats.stale += 1
            self._evict_group(group)
            return _MISSING
        return val

    def _hit(self, key: Tuple, key_arrays: Sequence):
        self._store.move_to_end(key)
        self.stats.hits += 1
        self.stats.bytes_avoided += sum(nbytes_of(a) for a in key_arrays)
        self.stats.recompute_seconds_avoided += self._cost.get(key, 0.0)

    def _insert(self, key: Tuple, val: Any, cost: float,
                key_arrays: Sequence = ()):
        group = _group(key)
        src = self._sources.get(group)
        if src is None or not src.confirm(key_arrays):
            # a new matrix, or other bytes under a matching sample: the
            # group's older entries were built from something else
            self._evict_group(group)
            self._sources[group] = _Sources(key_arrays)
        self._store[key] = val
        self._store.move_to_end(key)
        self._cost[key] = cost
        while len(self._store) > self.max_entries:
            victim, _ = self._store.popitem(last=False)
            self._cost.pop(victim, None)
            self._forget(victim)
            self.stats.evictions += 1

    def get(self, spec_name: str, key_arrays: Tuple, compute: Callable[[], Any]):
        """Cached value for ``spec_name`` derived from ``key_arrays``;
        recomputed only if a source array changed (the mprotect analogue)."""
        key = self._key(spec_name, key_arrays)
        val = self._lookup(key, key_arrays)
        if val is not _MISSING:
            self._hit(key, key_arrays)
            return val
        self.stats.misses += 1
        if faults.ACTIVE is not None:
            faults.fail("marshal_raise", spec_name)
        val, cost = _timed(compute)
        self._spec_cost[spec_name] = cost
        self._insert(key, val, cost, key_arrays)
        return val

    def marshal_seconds(self, repack_names: Sequence[str]) -> float:
        """The last measured seconds of the named repacks (0.0 for one
        that never ran here)."""
        return sum(self._spec_cost.get(n, 0.0) for n in repack_names)

    def keys(self) -> set:
        """The keys of the entries held now."""
        return set(self._store)

    def evict(self, keys) -> None:
        """Drop the entries under ``keys`` (absent keys are ignored)."""
        for k in keys:
            self._store.pop(k, None)
            self._cost.pop(k, None)
            self._forget(k)

    def _evict_group(self, group: Tuple) -> None:
        self.evict([k for k in self._store if _group(k) == group])

    def _forget(self, key: Tuple) -> None:
        """Drop the sources of ``key``'s group once no entry of it is
        left."""
        group = _group(key)
        if not any(_group(k) == group for k in self._store):
            self._sources.pop(group, None)

    def clear(self):
        self._store.clear()
        self._cost.clear()
        self._sources.clear()


class LoopCache:
    """A host loop's front for a marshaling cache or data plane (the steps
    of a scan, ``rewrite._eval_scan_body``): a marshal clause whose key
    values are the objects an earlier step keyed it on, at the same
    :func:`version_token`, gets that step's value back with no fingerprint
    read (the matrix a solver's step closes over); any other call goes to
    the cache behind it.  It holds the key values it compares, so no other
    tensor takes their address while it lives."""
    __slots__ = ("_inner", "_last")

    def __init__(self, inner):
        self._inner = inner
        self._last: Dict[Any, Tuple] = {}

    def _served(self, clause, keys: Sequence, fetch: Callable[[], Any]):
        tokens = tuple(version_token(k) for k in keys)
        last = self._last.get(clause)
        if last is not None and last[0] == tokens:
            return last[2]
        val = fetch()
        self._last[clause] = (tokens, keys, val)
        return val

    def get(self, name, keys, compute):
        return self._served(name, keys,
                            lambda: self._inner.get(name, keys, compute))

    def ensure(self, src, dst, keys, binding, fallback=None):
        return self._served((src, dst), keys, lambda: self._inner.ensure(
            src, dst, keys, binding, fallback=fallback))

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _seconds(step) -> float:
    """A loader's or an edge's most recent seconds, else its estimate."""
    return step.last if step.last is not None else step.cost()


class DataPlane(MarshalingCache):
    """The shared plan-level cache: format-aware marshaling over the
    conversion graph.

    ``ensure(src, dst, key_arrays, binding)`` materializes format ``dst``
    for the matrix identified by ``key_arrays``' fingerprints: a cache hit
    returns the persistent buffer; otherwise the cheapest path from any
    cached intermediate of the same matrix (cost 0) or from the binding
    loader runs, and every intermediate is cached.  One ``ensure`` counts
    as ONE hit or miss in ``stats``.
    """

    def __init__(self, policy: Optional[MarshalPolicy] = None):
        policy = policy or MarshalPolicy()
        super().__init__(max_entries=policy.max_entries)
        self.policy = policy
        self.plans: Dict[Tuple[str, str], PlanStats] = {}

    def _node_key(self, src: str, fmt: str, fps: Tuple) -> Tuple:
        return ("node", src, fmt) + fps

    def _plan_stats(self, src: str, dst: str) -> PlanStats:
        ps = self.plans.get((src, dst))
        if ps is None:
            ps = self.plans[(src, dst)] = PlanStats(src, dst)
        return ps

    def ensure(self, src: str, dst: str, key_arrays: Sequence,
               binding: Dict[str, Any],
               fallback: Optional[Callable[[], Any]] = None):
        """Materialize format ``dst`` for the matrix identified by the
        fingerprints of ``key_arrays``, via the cheapest conversion path.
        ``fallback`` (the clause's repack) runs when no path exists."""
        loader = SOURCES.get(src)
        if loader is None or dst not in FORMATS:
            if fallback is None:
                raise KeyError(f"unknown marshal source {src!r} or "
                               f"format {dst!r} and no fallback repack")
            return self.get(f"{src}->{dst}", tuple(key_arrays), fallback)

        fps = tuple(key_fingerprint(a) for a in key_arrays)
        key = self._node_key(src, dst, fps)
        ps = self._plan_stats(src, dst)
        val = self._lookup(key, key_arrays)
        if val is not _MISSING:
            self._hit(key, key_arrays)
            ps.hits += 1
            ps.bytes_avoided += sum(nbytes_of(a) for a in key_arrays)
            ps.seconds_avoided += self._cost.get(key, 0.0)
            return val

        self.stats.misses += 1
        ps.misses += 1
        if faults.ACTIVE is not None:
            faults.fail("marshal_raise", f"{src}->{dst}")
        # start set: cached intermediates of the SAME matrix (cost 0) plus
        # the binding loader at its measured cost
        starts: Dict[str, float] = {}
        cached_keys: Dict[str, Tuple] = {}
        for k in list(self._store):
            if (isinstance(k, tuple) and len(k) == 3 + len(fps)
                    and k[0] == "node" and k[1] == src and k[3:] == fps
                    and k[2] not in NO_TRANSIT
                    and self._lookup(k, key_arrays) is not _MISSING):
                starts[k[2]] = 0.0
                cached_keys[k[2]] = k
        starts.setdefault(loader.fmt, loader.cost())

        plan = GRAPH.plan(starts, dst)
        if plan is None:
            if fallback is None:
                raise KeyError(f"no conversion path {src}({loader.fmt})"
                               f"->{dst} and no fallback repack")
            val, cost = _timed(fallback)
            ps.build_seconds += cost
            ps.last_path = (f"{src}!fallback", dst)
            self._insert(key, val, cost, key_arrays)
            return val

        start_fmt, path, _ = plan
        paid = 0.0
        if start_fmt in cached_keys:
            # ride an already-cached intermediate (possibly built for a
            # different harness): the plan-level sharing win
            val = self._store[cached_keys[start_fmt]]
            self._store.move_to_end(cached_keys[start_fmt])
            self.stats.shared_edge_hits += 1
        else:
            val, paid = loader.run(binding)
            self.stats.loader_runs += 1
            self._insert(self._node_key(src, start_fmt, fps), val, paid,
                         key_arrays)
        for e in path:
            val, dt = e.run(val)
            paid += dt
            self.stats.edge_runs += 1
            # cost = cumulative seconds paid to produce it in THIS ensure
            self._insert(self._node_key(src, e.dst, fps), val, paid,
                         key_arrays)
        ps.build_seconds += paid
        ps.last_path = (start_fmt,) + tuple(e.dst for e in path)
        return val

    def estimate_marshal_seconds(self, clauses: Sequence[Any]) -> float:
        """Repack seconds of a harness's marshal clauses from the binding,
        sharing-independent: the loader plus the edges of the cheapest full
        conversion path, each at the seconds of its most recent run (the
        autotuner asks right after a warm-up call ran them for this
        matrix); a clause without a path, or without formats, counts its
        repack's last seconds."""
        total = 0.0
        for cl in clauses:
            src, dst = getattr(cl, "src", None), getattr(cl, "dst", None)
            loader = SOURCES.get(src)
            if loader is not None and dst in FORMATS:
                plan = GRAPH.plan({loader.fmt: loader.cost()}, dst)
                if plan is not None:
                    total += _seconds(loader) + sum(_seconds(e)
                                                    for e in plan[1])
                    continue
                ps = self.plans.get((src, dst))
                if ps is not None and ps.misses:
                    total += ps.build_seconds / ps.misses
                    continue
            total += self._spec_cost.get(cl.repack, 0.0)
        return total

    def plan_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-plan accounting: '{src}->{dst}' -> stats."""
        return {f"{src}->{dst}": dataclasses.asdict(ps)
                for (src, dst), ps in sorted(self.plans.items())}


class ReadObject:
    """Paper Fig. 14: a value derived from an input with change tracking.
    ``construct(arr)`` runs on the first read and when the input's shape
    changes (after ``destruct`` of the old state), ``update(arr, state)``
    when its content changes (:func:`fingerprint`, sampled above 64 KiB
    unless ``exact``), ``destruct(state)`` on ``release``.  The shape is
    read from the tensor, so no read copies it to the host."""

    def __init__(self, construct: Callable, update: Callable,
                 destruct: Optional[Callable] = None, exact: bool = False):
        self.construct = construct
        self.update = update
        self.destruct = destruct
        self.exact = exact
        self._state: Optional[Any] = None
        self._fp: Optional[Tuple] = None
        self._shape: Optional[Tuple] = None

    def read(self, arr):
        fp = fingerprint(arr, self.exact)
        value = unwrap(arr)
        shape = tuple(value.shape)
        if self._state is None or shape != self._shape:
            if self._state is not None and self.destruct is not None:
                self.destruct(self._state)
            self._state = None
            self._state = self.construct(value)
            self._fp, self._shape = fp, shape
        elif fp != self._fp:
            self._state = self.update(value, self._state)
            self._fp = fp
        return self._state

    def release(self) -> None:
        if self._state is not None and self.destruct is not None:
            self.destruct(self._state)
        self._state = self._fp = self._shape = None
