"""Joint whole-program plan optimization (Linnea-inspired).

Counterpart of ``repro.core.plan_search``.  Per-match selection
(``autotune.Autotuner.select``) is a greedy argmin: each match
independently minimizes ``kernel + marshal/reuse`` as if it were the only
harness call in the program.  But the shared data plane makes choices
*coupled*: picking BCSR for match A turns match B's
CSR->BCSR repack into a cost-0 ride on A's cached buffer, so the
independently-optimal picks can be jointly wrong — a program with two
spmv matches on the same matrix may greedily pick the repack-free backend
twice when paying one shared repack and running the faster kernel twice
is cheaper end to end (Linnea, arXiv:1912.12924: generalized-cost search
over whole-program variant assignments beats local greedy choices).

This module is that search, run by the pass manager once per
``CompiledEntry`` after every match has a definitive per-match decision:

* one :class:`Candidate` per measured (harness, schedule, fuse) variant,
  built from the autotune cache's schema-4 per-candidate components —
  nothing is re-timed;
* marshal requirements (:class:`MarshalReq`) carry the *matrix identity*
  (the binding atoms the repack keys on), so the cost model knows when
  two matches marshal the same operand;
* :func:`search` beam-searches joint assignments over all matches.  The
  shared marshal term uses ``ConversionGraph.plan_cost`` as the oracle:
  a format another assignment already builds enters at cost 0, a partial
  prefix (e.g. a cached DENSE when BCSR is wanted) enters at the
  remaining edges' EWMA cost, everything amortized by
  ``MarshalPolicy.reuse``;
* per-match priors (the pinned winners) rank first in every candidate
  table, and the result is clamped to never cost more than the greedy
  baselines — widening the beam can only help.

The port's tuner store is schema 4 only (``repro_torch.core.autotune``),
so the reference's paths for schema-3 records have no counterpart.

Knob: ``LILAC_TORCH_SEARCH_BEAM`` — beam width (default 8); ``0`` disables
the joint pass entirely (pure per-match greedy).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

ENV_BEAM = "LILAC_TORCH_SEARCH_BEAM"
DEFAULT_BEAM = 8


def beam_width() -> int:
    """Joint-search beam width from ``LILAC_TORCH_SEARCH_BEAM`` (default 8;
    0 disables the joint pass)."""
    try:
        return int(os.environ.get(ENV_BEAM, DEFAULT_BEAM))
    except ValueError:
        return DEFAULT_BEAM


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MarshalReq:
    """One marshal clause of a candidate, as the cost model sees it.

    ``matrix`` is a hashable identity of the operands the repack keys on
    (binding atoms) — two requirements with equal ``(matrix, src)`` feed
    from the same cached intermediates.  ``full_s`` is the measured
    full-path cost from the binding; ``scale`` converts the conversion
    graph's (EWMA-estimated) path costs into the same units, so partial
    prefix rides are priced consistently with the measured total.  Legacy
    format-less clauses have ``src = dst = None``: fixed cost, never
    shared."""
    matrix: Any
    src: Optional[str]
    dst: Optional[str]
    full_s: float = 0.0
    scale: float = 1.0


@dataclasses.dataclass
class Candidate:
    """One measured (harness, schedule, fuse) variant of one match."""
    harness: str
    kernel_s: float
    schedule: Optional[Dict[str, Any]] = None
    fuse: Optional[bool] = None
    reqs: Tuple[MarshalReq, ...] = ()

    def pin(self) -> Tuple[str, Optional[Dict[str, Any]], Optional[bool]]:
        return (self.harness, self.schedule, self.fuse)


#: a beam state's "what is already materialized": (matrix, src, format)
BuiltSet = FrozenSet[Tuple[Any, Optional[str], str]]


def _req_cost(req: MarshalReq, built: BuiltSet, graph, sources
              ) -> Tuple[float, Tuple[Tuple[Any, Optional[str], str], ...]]:
    """Seconds to satisfy one marshal requirement given what earlier
    assignments already build, plus the (matrix, src, format) nodes doing
    so would materialize.  Exact hit -> 0; partial prefix -> remaining
    path cost via ``graph.plan_cost``; otherwise the measured full-path
    cost from the binding."""
    if req.src is None or req.dst is None:
        return req.full_s, ()
    have = {fmt for (mk, s, fmt) in built
            if mk == req.matrix and s == req.src}
    if req.dst in have:
        return 0.0, ()
    cost, produced = req.full_s, None
    if have and graph is not None:
        res = graph.plan_cost({f: 0.0 for f in have}, req.dst)
        if res is not None:
            ride = res[0] * req.scale
            if ride < cost:
                cost, produced = ride, res[1]
    if produced is None:
        # full path from the binding loader: record the intermediates the
        # data plane will cache along the way (later matches ride them)
        produced = (req.dst,)
        loader = (sources or {}).get(req.src)
        if loader is not None and graph is not None:
            res = graph.plan_cost({loader.fmt: loader.cost()}, req.dst)
            if res is not None:
                produced = res[1]
    return cost, tuple((req.matrix, req.src, f) for f in produced)


def assignment_step(cand: Candidate, built: BuiltSet, graph, sources,
                    reuse: float) -> Tuple[float, BuiltSet]:
    """Amortized cost of adding ``cand`` to a partial assignment whose
    materialized formats are ``built``; returns (cost, updated built)."""
    rate = max(float(reuse or 1.0), 1.0)
    cost = cand.kernel_s
    new_built = set(built)
    for req in cand.reqs:
        c, produced = _req_cost(req, frozenset(new_built), graph, sources)
        cost += c / rate
        new_built.update(produced)
    return cost, frozenset(new_built)


def cost_of_assignment(picks: Sequence[Candidate], graph, sources,
                       reuse: float) -> float:
    """End-to-end amortized cost of a full assignment WITH sharing — the
    data plane shares cached intermediates at runtime no matter how the
    decisions were made, so even independently-chosen picks are priced
    with the ride."""
    built: BuiltSet = frozenset()
    total = 0.0
    for cand in picks:
        c, built = assignment_step(cand, built, graph, sources, reuse)
        total += c
    return total


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def independent_assignment(tables: Sequence[Sequence[Candidate]],
                           graph=None, sources=None, reuse: float = 1.0
                           ) -> Tuple[List[Candidate], float]:
    """The pre-joint behavior: each match independently minimizes its own
    amortized cost with the full repack charged (sharing-blind), exactly
    what per-match ``Autotuner.select`` does.  The returned cost evaluates
    the resulting assignment WITH sharing (the runtime shares regardless),
    so it is directly comparable to :func:`search`'s."""
    picks = [min(cands, key=lambda c: assignment_step(
        c, frozenset(), graph, sources, reuse)[0]) for cands in tables]
    return picks, cost_of_assignment(picks, graph, sources, reuse)


def greedy_assignment(tables: Sequence[Sequence[Candidate]],
                      graph=None, sources=None, reuse: float = 1.0
                      ) -> Tuple[List[Candidate], float]:
    """Sequential local argmin with shared state: match i sees what
    matches < i built.  Equivalent to :func:`search` at beam width 1."""
    built: BuiltSet = frozenset()
    picks: List[Candidate] = []
    total = 0.0
    for cands in tables:
        best = None
        for cand in cands:
            c, nb = assignment_step(cand, built, graph, sources, reuse)
            if best is None or c < best[0]:
                best = (c, cand, nb)
        total += best[0]
        picks.append(best[1])
        built = best[2]
    return picks, total


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    assignment: List[Candidate]
    cost: float
    greedy_cost: float        # sequential shared-state baseline (beam=1)
    independent_cost: float   # per-match sharing-blind argmin (pre-joint)
    beam_width: int
    explored: int             # states expanded
    frontier: List[Dict[str, Any]]   # surviving final beam states

    @property
    def joint_vs_independent(self) -> float:
        """Speedup of the joint assignment over independent per-match
        winners (>= 1.0 by construction)."""
        return (self.independent_cost / self.cost) if self.cost > 0 else 1.0

    def report(self) -> Dict[str, Any]:
        """JSON-serializable summary for ``plan_info()`` / benchmarks."""
        return {
            "assignment": [[c.harness, c.schedule, c.fuse]
                           for c in self.assignment],
            "cost_s": self.cost,
            "greedy_cost_s": self.greedy_cost,
            "independent_cost_s": self.independent_cost,
            "joint_vs_independent": self.joint_vs_independent,
            "beam_width": self.beam_width,
            "explored": self.explored,
            "frontier": self.frontier,
        }


def search(tables: Sequence[Sequence[Candidate]], graph=None, sources=None,
           reuse: float = 1.0, width: Optional[int] = None) -> SearchResult:
    """Beam search over joint assignments: one candidate per match, costed
    with shared marshal state.  ``tables[i]`` lists match i's candidates,
    prior (currently pinned winner) first — ties keep table order, so the
    prior wins when the model is indifferent.  The result never costs
    more than either baseline: both are in the search space, and the
    final answer is clamped to the best of (beam, greedy, independent)."""
    width = beam_width() if width is None else width
    width = max(1, int(width))
    explored = 0
    # states: (cost, built, pick indices) — dominance-pruned on built
    beam: List[Tuple[float, BuiltSet, List[int]]] = [(0.0, frozenset(), [])]
    for cands in tables:
        expanded: List[Tuple[float, BuiltSet, List[int]]] = []
        for cost0, built, picks in beam:
            for idx, cand in enumerate(cands):
                c, nb = assignment_step(cand, built, graph, sources, reuse)
                expanded.append((cost0 + c, nb, picks + [idx]))
                explored += 1
        expanded.sort(key=lambda s: s[0])   # stable: ties keep prior first
        beam, seen = [], set()
        for state in expanded:
            if state[1] in seen:    # same built set, costlier prefix:
                continue            # dominated, identical future costs
            seen.add(state[1])
            beam.append(state)
            if len(beam) >= width:
                break
    best_cost, _, best_idx = beam[0] if beam else (float("inf"), None, [])
    assignment = [tables[i][j] for i, j in enumerate(best_idx)]
    g_picks, g_cost = greedy_assignment(tables, graph, sources, reuse)
    i_picks, i_cost = independent_assignment(tables, graph, sources, reuse)
    # never-worse guarantee: a pruned-too-early beam falls back to the
    # better baseline rather than regressing below it
    for alt_cost, alt_picks in ((g_cost, g_picks), (i_cost, i_picks)):
        if alt_cost < best_cost:
            best_cost, assignment = alt_cost, list(alt_picks)
    frontier = [{"cost_s": c,
                 "assignment": [[tables[i][j].harness,
                                 tables[i][j].schedule,
                                 tables[i][j].fuse]
                                for i, j in enumerate(idxs)]}
                for c, _, idxs in beam[:width]]
    return SearchResult(assignment=assignment, cost=best_cost,
                        greedy_cost=g_cost, independent_cost=i_cost,
                        beam_width=width, explored=explored,
                        frontier=frontier)


# ---------------------------------------------------------------------------
# CompiledEntry adapter (pass_manager hook)
# ---------------------------------------------------------------------------

def _matrix_key(match, clause) -> Tuple:
    """Identity of the operands a marshal clause keys on: the binding
    nodes (or literals), so two matches over the same tensors in one
    program — the coupled case — share the key."""
    parts: List[Any] = [clause.repack]
    for alts in getattr(clause, "keys", ()) or ():
        for k in alts:
            if k in match.binding:
                v = match.binding[k]
                parts.append(v if isinstance(v, (int, float, bool, str))
                             else id(v))
                break
    return tuple(parts)


def _graph_of(cache):
    """The conversion graph a data plane plans over (None without one)."""
    from repro_torch.core.marshal import GRAPH

    return GRAPH if hasattr(cache, "ensure") else None


def _reqs_for(harness, match, rec_marshal_s: Optional[float], cache
              ) -> Tuple[MarshalReq, ...]:
    """Marshal requirements of one harness at one match, priced from the
    conversion graph's measured path costs and rescaled so the clause
    total matches the record's measured ``marshal_s`` (single-clause
    harnesses — all the builtins — get exactly the measured figure)."""
    from repro_torch.core.marshal import FORMATS, SOURCES

    clauses = getattr(harness, "marshal", ()) or ()
    if not clauses:
        return ()
    graph = _graph_of(cache)
    raw: List[Tuple[Any, Optional[str], Optional[str], float]] = []
    for cl in clauses:
        src = getattr(cl, "src", None)
        dst = getattr(cl, "dst", None)
        mkey = _matrix_key(match, cl)
        if src in SOURCES and dst in FORMATS and graph is not None:
            loader = SOURCES[src]
            full = graph.full_path_cost(loader.fmt, dst,
                                        entry_cost=loader.cost())
            if full is not None:
                raw.append((mkey, src, dst, full))
                continue
        # legacy / unpathable clause: last measured repack seconds, not
        # shareable through the graph
        est = 0.0
        if cache is not None and hasattr(cache, "marshal_seconds"):
            est = cache.marshal_seconds([getattr(cl, "repack", str(cl))])
        raw.append((mkey, None, None, est))
    graph_total = sum(c for _, _, _, c in raw)
    scale = 1.0
    if rec_marshal_s is not None and rec_marshal_s > 0 and graph_total > 0:
        scale = rec_marshal_s / graph_total
    return tuple(MarshalReq(mk, src, dst, full_s=c * scale, scale=scale)
                 for mk, src, dst, c in raw)


def candidates_for_match(match, rec: Dict[str, Any], harnesses, cache,
                         prior: Optional[Tuple] = None) -> List[Candidate]:
    """Build match's candidate table from its autotune record's measured
    components (schema 4 ``variants`` when present, per-harness bests
    otherwise).  ``prior`` — the currently pinned (harness, schedule,
    fuse) — ranks first; the rest sort by kernel time."""
    timings = rec.get("timings") or {}
    schedules = rec.get("schedules") or {}
    fuses = rec.get("fuses") or {}
    variants = rec.get("variants") or {}
    out: List[Candidate] = []
    for h in harnesses:
        t = timings.get(h.name)
        if t is None:
            continue
        reqs = _reqs_for(h, match, (rec.get("marshal_s") or {}).get(h.name),
                         cache)
        fam = getattr(h, "schedules", ()) or ()
        vs = variants.get(h.name) or [[schedules.get(h.name),
                                       fuses.get(h.name), t]]
        for sched, fuse, vt in vs:
            if sched is not None and fam and sched not in fam:
                continue        # tune space changed since the record
            out.append(Candidate(harness=h.name, kernel_s=float(vt),
                                 schedule=sched, fuse=fuse, reqs=reqs))
    def rank(c: Candidate):
        is_prior = (prior is not None and c.pin() == tuple(prior))
        return (not is_prior, c.kernel_s)
    out.sort(key=rank)
    return out


def optimize_entry(flat_matches, pins: Dict[int, Tuple], *, registry,
                   tuner, platform: str, mode: str, cache,
                   reuse: float, width: Optional[int] = None
                   ) -> Optional[SearchResult]:
    """Run the joint search for a fully-pinned ``CompiledEntry``: rebuild
    every match's candidate table from recorded measurements (zero
    re-timing) and beam-search the joint assignment.  Returns None when
    any match lacks a servable record or candidates — the per-match pins
    stand in that case.  Quarantined candidates are left out."""
    from repro_torch.core import resilience as R
    from repro_torch.core.autotune import signature_of, variant_key
    from repro_torch.core.marshal import SOURCES

    q = R.shared_quarantine()
    graph = _graph_of(cache)
    tables: List[List[Candidate]] = []
    for i, m in enumerate(flat_matches):
        # the traced values key as the call's tensors do (shapes, dtypes)
        binding = {k: (v.meta.get("val") if hasattr(v, "meta") else v)
                   for k, v in m.binding.items()}
        sig = signature_of(m.computation, m.format, platform, binding,
                           epilogue=m.epilogue)
        rec = tuner.cache.get(sig, mode)
        if rec is None:
            return None
        cands = registry.candidates(m.computation, m.format, platform, mode)
        # a quarantined (harness, variant) never enters the assignment
        table = [c for c in candidates_for_match(m, rec, cands, cache,
                                                 prior=pins.get(i))
                 if not R.quarantined(q, m.computation, c.harness,
                                      variant_key(c.schedule, c.fuse))]
        if not table:
            return None
        tables.append(table)
    return search(tables, graph=graph, sources=SOURCES, reuse=reuse,
                  width=width)
