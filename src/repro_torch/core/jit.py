"""Compiled entry points: the reference's ``jax.jit`` sites as
``torch.compile``.

An :class:`Entry` is one function compiled by a named dynamo backend
(``"inductor"`` on the card; the CPU tests pass ``"aot_eager"``; a
backend callable, such as a recording one, also works).  Each entry
compiles a copy of the function's code object, so it has a dynamo cache
of its own: two entries of one Python function (two prompt lengths, two
training loops in one process) never share guards or count toward each
other's recompile limit.  Past dynamo's recompile limit an entry raises
(``fail_on_recompile_limit_hit``): it never falls back to running the
function uncompiled.  It counts what it compiled: ``compiles`` (graphs
handed to the backend), ``graph_breaks`` (dynamo's break counter over the
calls that compiled), ``compile_seconds`` (the wall time of those
calls, their run included) and ``calls``.
"""
from __future__ import annotations

import time
import types
from typing import Any, Callable, Optional, Union

import torch

#: the backend of the card's compiled entry points
DEFAULT_BACKEND = "inductor"


def backend_for(device) -> str:
    """Inductor on the card, aot_eager on the CPU: the backend of the
    examples, the launcher and the engine's default."""
    return DEFAULT_BACKEND if torch.device(device).type == "cuda" \
        else "aot_eager"


def fresh(fn: Callable) -> Callable:
    """``fn`` with a copy of its code object (the same globals, defaults
    and closure): dynamo keeps its cache on the code object, so the copy
    compiles and guards apart from ``fn`` and from every other copy."""
    out = types.FunctionType(fn.__code__.replace(), fn.__globals__,
                             fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    out.__qualname__ = fn.__qualname__
    out.__dict__.update(fn.__dict__)
    return out


def _break_count() -> int:
    from torch._dynamo.utils import counters
    return sum(counters["graph_break"].values())


class Entry:
    """``fn`` under ``torch.compile(backend=backend, fullgraph=fullgraph)``
    at static shapes (a new shape compiles a graph of its own) on a code
    object of its own (:func:`fresh`)."""

    def __init__(self, fn: Callable, backend: Union[str, Callable], *,
                 fullgraph: bool = True, recompile_limit: Optional[int] = None,
                 name: Optional[str] = None):
        if backend is None:
            raise ValueError("an Entry compiles: name its backend")
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "entry")
        self.backend = backend
        self.fullgraph = fullgraph
        self._config = {"fail_on_recompile_limit_hit": True}
        if recompile_limit is not None:
            self._config["recompile_limit"] = recompile_limit
        self.compiles = 0
        self.graph_breaks = 0
        self.compile_seconds = 0.0
        self.calls = 0
        import torch._dynamo

        inner = (torch._dynamo.lookup_backend(backend)
                 if isinstance(backend, str) else backend)

        def counted(gm, example_inputs):
            self.compiles += 1
            return inner(gm, example_inputs)

        self._compiled = torch.compile(fresh(fn), backend=counted,
                                       fullgraph=fullgraph, dynamic=False)

    def __call__(self, *args, **kwargs) -> Any:
        compiles, breaks = self.compiles, _break_count()
        t0 = time.perf_counter()
        with torch._dynamo.config.patch(**self._config):
            out = self._compiled(*args, **kwargs)
        if self.compiles != compiles:
            self.compile_seconds += time.perf_counter() - t0
            self.graph_breaks += _break_count() - breaks
        self.calls += 1
        return out

    def stats(self) -> dict:
        return {"name": self.name, "backend": str(self.backend),
                "fullgraph": self.fullgraph, "compiles": self.compiles,
                "graph_breaks": self.graph_breaks,
                "compile_seconds": self.compile_seconds, "calls": self.calls}
