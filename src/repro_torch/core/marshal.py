"""LiLAC-How data plane: formats, conversion planning, invariant caching
(paper §3.3.2, §4.2, Fig. 8/9/10/18).

Counterpart of ``repro.core.marshal``.  The paper tracks writes to host
arrays with memory protection so that device transfers and data-dependent
invariants are recomputed only when the memory changed; here "did this
matrix change?" is answered with content fingerprints at the harness call.

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
  harnesses targeting one format share one cached buffer.

Constructors hand back tensors on the device of their input, so a marshaled
format built from CUDA operands stays on the card between calls.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

_SMALL = 1 << 16  # full-hash threshold in bytes

_MISSING = object()


def fingerprint(arr: Any, exact: bool = False) -> Tuple:
    """Content fingerprint of a tensor (or Python scalar)."""
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


def nbytes_of(x) -> int:
    """Size of a tensor from its metadata; 0 for scalars and None."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


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
    runs: int = 0

    def cost(self) -> float:
        return self.measured if self.measured is not None else self.est_cost

    def run(self, value) -> Tuple[Any, float]:
        t0 = time.perf_counter()
        out = self.fn(value)
        dt = time.perf_counter() - t0
        self.measured = dt if self.measured is None \
            else 0.7 * self.measured + 0.3 * dt
        self.runs += 1
        return out, dt


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

    def cost(self) -> float:
        return self.measured if self.measured is not None else 0.1

    def run(self, binding) -> Tuple[Any, float]:
        t0 = time.perf_counter()
        out = self.fn(binding)
        dt = time.perf_counter() - t0
        self.measured = dt if self.measured is None \
            else 0.7 * self.measured + 0.3 * dt
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
# Stats
# ---------------------------------------------------------------------------

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
    ``MAX_ENTRIES`` of them: the least recently used goes first."""

    MAX_ENTRIES = 64

    def __init__(self):
        self._store: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._cost: Dict[Tuple, float] = {}
        self.stats = CacheStats()

    def _key(self, spec_name: str, key_arrays: Sequence) -> Tuple:
        return (spec_name,) + tuple(fingerprint(a) for a in key_arrays)

    def _hit(self, key: Tuple, key_arrays: Sequence):
        self._store.move_to_end(key)
        self.stats.hits += 1
        self.stats.bytes_avoided += sum(nbytes_of(a) for a in key_arrays)
        self.stats.recompute_seconds_avoided += self._cost.get(key, 0.0)

    def _insert(self, key: Tuple, val: Any, cost: float):
        self._store[key] = val
        self._store.move_to_end(key)
        self._cost[key] = cost
        while len(self._store) > self.MAX_ENTRIES:
            victim, _ = self._store.popitem(last=False)
            self._cost.pop(victim, None)
            self.stats.evictions += 1

    def get(self, spec_name: str, key_arrays: Tuple, compute: Callable[[], Any]):
        """Cached value for ``spec_name`` derived from ``key_arrays``;
        recomputed only if a source array changed (the mprotect analogue)."""
        key = self._key(spec_name, key_arrays)
        val = self._store.get(key, _MISSING)
        if val is not _MISSING:
            self._hit(key, key_arrays)
            return val
        self.stats.misses += 1
        t0 = time.perf_counter()
        val = compute()
        self._insert(key, val, time.perf_counter() - t0)
        return val

    def clear(self):
        self._store.clear()
        self._cost.clear()


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

    def __init__(self):
        super().__init__()
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

        fps = tuple(fingerprint(a) for a in key_arrays)
        key = self._node_key(src, dst, fps)
        ps = self._plan_stats(src, dst)
        val = self._store.get(key, _MISSING)
        if val is not _MISSING:
            self._hit(key, key_arrays)
            ps.hits += 1
            ps.bytes_avoided += sum(nbytes_of(a) for a in key_arrays)
            ps.seconds_avoided += self._cost.get(key, 0.0)
            return val

        self.stats.misses += 1
        ps.misses += 1
        # start set: cached intermediates of the SAME matrix (cost 0) plus
        # the binding loader at its measured cost
        starts: Dict[str, float] = {}
        cached_keys: Dict[str, Tuple] = {}
        for k in self._store:
            if (isinstance(k, tuple) and len(k) == 3 + len(fps)
                    and k[0] == "node" and k[1] == src and k[3:] == fps
                    and k[2] not in NO_TRANSIT):
                starts[k[2]] = 0.0
                cached_keys[k[2]] = k
        starts.setdefault(loader.fmt, loader.cost())

        plan = GRAPH.plan(starts, dst)
        if plan is None:
            if fallback is None:
                raise KeyError(f"no conversion path {src}({loader.fmt})"
                               f"->{dst} and no fallback repack")
            t0 = time.perf_counter()
            val = fallback()
            cost = time.perf_counter() - t0
            ps.build_seconds += cost
            ps.last_path = (f"{src}!fallback", dst)
            self._insert(key, val, cost)
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
            self._insert(self._node_key(src, start_fmt, fps), val, paid)
        for e in path:
            val, dt = e.run(val)
            paid += dt
            self.stats.edge_runs += 1
            # cost = cumulative seconds paid to produce it in THIS ensure
            self._insert(self._node_key(src, e.dst, fps), val, paid)
        ps.build_seconds += paid
        ps.last_path = (start_fmt,) + tuple(e.dst for e in path)
        return val

    def plan_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-plan accounting: '{src}->{dst}' -> stats."""
        return {f"{src}->{dst}": dataclasses.asdict(ps)
                for (src, dst), ps in sorted(self.plans.items())}
