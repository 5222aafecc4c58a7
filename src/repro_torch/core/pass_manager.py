"""The user-facing LiLAC pass (the paper's Fig. 1 compiler flow).

Counterpart of ``repro.core.pass_manager``, host mode only:
``compile(fn, mode="host")`` returns a callable that, per input signature,
traces ``fn`` into an aten-level FX graph, detects sparse computations in
it and replaces them with harness calls; every call then runs the
rewritten graph eagerly, with the call's data plane amortizing format
repacks across calls (paper Fig. 18).  Policies are ``"default"`` (the
platform's default harness) or an explicit harness name.

The compiled function runs on the card: ``platform="cuda"`` unless the
caller passes ``platform="cpu"`` (or ``device="cpu"``).  Asking for CUDA
where no card is present raises, and so do operands on another device —
the pass never falls back to the CPU quietly.  Not ported yet: trace mode,
autotuning, executable plans, the plan cache and fault containment; a
harness that raises makes the call raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import detect as D
from repro_torch.core import harness as H
from repro_torch.core.marshal import DataPlane
from repro_torch.core.rewrite import needed_nodes, run_rewritten


@dataclasses.dataclass
class CompiledEntry:
    gm: Any                          # the traced, normalized FX graph
    report: D.DetectionReport
    tensor_pos: Tuple[int, ...]      # flat-argument positions of tensors
    out_spec: Any                    # pytree spec of the output
    needed: frozenset                # rewrite.needed_nodes of the report


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
    """A function passed through the LiLAC pass (host mode)."""

    def __init__(self, fn: Callable, *, mode: str = "host",
                 policy: str = "default", platform: Optional[str] = None,
                 device=None):
        if mode != "host":
            raise NotImplementedError(
                f"mode={mode!r}: only host mode is ported so far")
        if policy == "autotune":
            raise NotImplementedError(
                "policy='autotune' is not ported yet; use 'default' or a "
                "harness name")
        self.fn = fn
        self.mode = mode
        self.policy = policy
        self.platform = resolve_platform(platform, device)
        self.cache = DataPlane()
        self._compiled: Dict[Tuple, CompiledEntry] = {}
        # set-up paid per input signature: traces run and the seconds spent
        # tracing and detecting (repacks are the data plane's: cache.plans)
        self.stats = {"traces": 0, "trace_seconds": 0.0, "detect_seconds": 0.0}
        self.last_report: Optional[D.DetectionReport] = None
        # (match, harness-name) pairs from the most recent call, in anchor
        # order: what actually ran
        self.last_selections: List[Tuple[D.Match, str]] = []

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
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        entry = self._compiled.get(key)
        if entry is None:
            entry = self._compiled[key] = self._build_entry(leaves, spec)
        self.last_report = entry.report
        return entry

    # -- execution -----------------------------------------------------------

    def _select(self, m: D.Match) -> H.Harness:
        return H.REGISTRY.select(m.computation, m.format, self.platform,
                                 self.mode, policy=self.policy)

    def _ctx_factory(self, m: D.Match) -> H.CallCtx:
        return H.CallCtx(mode=self.mode, cache=self.cache, format=m.format,
                         platform=self.platform, epilogue=m.epilogue)

    def __call__(self, *args, **kwargs):
        leaves, spec = tree_flatten((args, kwargs))
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.device.type != self.platform:
                raise ValueError(
                    f"compiled for {self.platform!r} but got a tensor on "
                    f"{x.device}")
        entry = self._entry_for(leaves, spec)
        selections: List[Tuple[D.Match, str]] = []
        outs = run_rewritten(
            entry.gm, entry.report.matches, self._select,
            [leaves[i] for i in entry.tensor_pos], self._ctx_factory,
            on_select=lambda m, h: selections.append((m, h.name)),
            needed=entry.needed)
        self.last_selections = selections
        return tree_unflatten(outs, entry.out_spec)


def compile(fn: Callable, *, mode: str = "host", policy: str = "default",
            platform: Optional[str] = None, device=None) -> LilacFunction:
    """The single LiLAC entry point: pass ``fn`` through the pass.

    ``mode``      'host' (eager with the data plane — the paper's runtime
                  model); trace mode is not ported yet.
    ``policy``    'default' | an explicit harness name.
    ``platform``  'cuda' (the default; raises without a card) or 'cpu'.
    ``device``    alternative spelling: its type picks the platform.
    """
    return LilacFunction(fn, mode=mode, policy=policy, platform=platform,
                         device=device)
