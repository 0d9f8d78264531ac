"""Launch counts of the port's CUDA kernels, CUDA graphs included.

Each wrapper keeps its kernel's count as a plain int in its own module
(``epl_correlator.launch_count``, ``track_block_fused.launch_count``, ...)
and calls ``record`` where it launches the kernel, and nowhere else. A
launch recorded into a CUDA graph runs on each replay, not at the call:
while a ``Graph`` captures, ``record`` files the launch under that graph,
and ``Graph.replay`` adds the graph's launches to the counts each time it
replays it. So a count is what the card ran, whether it ran eagerly or
from a graph.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading

import torch

_open = threading.local()           # .launches: the capture open here


def record(module: str, count: str) -> None:
    """One launch of the kernel counted in ``module``'s int ``count``
    (the launching thread's current stream: eager, or captured)."""
    if torch.cuda.is_current_stream_capturing():
        launches = getattr(_open, "launches", None)
        if launches is None:
            raise RuntimeError(f"{module}.{count}: a launch captured outside "
                               "launches.Graph would never be counted")
        launches[(module, count)] += 1
        return
    mod = sys.modules[module]
    setattr(mod, count, getattr(mod, count) + 1)


class Graph:
    """A ``torch.cuda.CUDAGraph`` that knows the counted kernel launches
    captured into it."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: collections.Counter = collections.Counter()

    @contextlib.contextmanager
    def capture(self, **kwargs):
        """``torch.cuda.graph(self.graph, **kwargs)``, filing the launches
        recorded inside it under this graph."""
        launches = collections.Counter()
        prev = getattr(_open, "launches", None)
        _open.launches = launches
        try:
            with torch.cuda.graph(self.graph, **kwargs):
                yield self
        finally:
            _open.launches = prev
        self.launches = launches

    def replay(self) -> None:
        """Replay the graph and count the launches it holds."""
        self.graph.replay()
        for (module, count), n in self.launches.items():
            mod = sys.modules[module]
            setattr(mod, count, getattr(mod, count) + n)
