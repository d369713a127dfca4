"""The port's CUDA-graph capture and its kernels' launch ledger.

The ledger counts how many times each hand-written kernel ran, graph
replays included. Each kernel module registers the wrapper names it owns
once, at import (``LAUNCHES = _graph.register("decode_attention")``), and
keeps the dict it gets back as its ``LAUNCHES``: wrapper name -> launches
that ran on the card. At each launch the wrapper calls ``count(name, n)``.
A call made while the current stream captures a CUDA graph runs nothing:
it adds to ``CAPTURED`` instead (wrapper name -> launches recorded into
graphs, never reset), and the graph's ``replay`` adds the launches it
holds. ``reset()`` zeroes every module's ``LAUNCHES``.

``capture`` is the one place the port captures a graph: ``launch/serve.py``'s
decode step, ``launch/train.py``'s train step, and ``core/train.py``'s
bucket forwards and GNN training programs.
"""
from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.obs.device import span as obs_span

# wrapper name -> the ``LAUNCHES`` dict of the kernel module that owns it
COUNTERS: dict[str, dict[str, int]] = {}
# wrapper name -> launches recorded into CUDA graphs being captured
CAPTURED: dict[str, int] = {}


def register(*names: str) -> dict[str, int]:
    """A kernel module's ``LAUNCHES``: a zeroed counter per wrapper name,
    each name owned by this one module."""
    launches = dict.fromkeys(names, 0)
    for name in names:
        if name in COUNTERS:
            raise ValueError(f"launch counter {name!r} is registered twice")
        COUNTERS[name] = launches
        CAPTURED[name] = 0
    return launches


def count(name: str, n: int = 1) -> None:
    """``n`` launches of ``name``: into ``CAPTURED`` while the current
    stream captures, else into its module's ``LAUNCHES``."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += n
    else:
        COUNTERS[name][name] += n


def count_replays(held: dict[str, int]) -> None:
    """Add the launches that one replay of a captured graph ran (``held``:
    name -> launches, the growth of ``CAPTURED`` over its capture)."""
    for name, n in held.items():
        COUNTERS[name][name] += n


def reset() -> None:
    """Zero every registered launch count."""
    for name, launches in COUNTERS.items():
        launches[name] = 0


class Graph(torch.cuda.CUDAGraph):
    """A CUDA graph whose ``replay`` also adds ``held``, the launches it
    holds (wrapper name -> launches, those above 0), to the ledger. It
    holds the memory of its intermediates until ``reset``."""

    held: dict[str, int] = {}

    def replay(self) -> None:
        super().replay()
        count_replays(self.held)


def capture(body, device: torch.device, *, warmup=None, pool=None,
            span: str | None = None):
    """Capture ``body()`` on ``device`` as a CUDA graph; returns the graph
    and what the warm-up returned.

    On the device's side stream, once it has waited for the current
    stream, the warm-up runs eagerly first (``warmup()``, or ``body()``
    without one), as autograd and the kernels need before a capture; its
    launches count as they run. Then ``body()`` is captured into ``pool``
    (a new pool when None), inside the span ``span`` if one is named,
    which runs nothing; the current stream waits for the side stream
    before this returns. A capture that fails raises."""
    side = _device.side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    before = CAPTURED.copy()
    graph = Graph()
    with torch.cuda.stream(side):
        warm = (warmup or body)()
        # capture_begin, not torch.cuda.graph(): that one empties the
        # allocator's cache first, and the next eager call would pay to
        # allocate its memory again
        with obs_span(span):
            graph.capture_begin(pool=pool)
            try:
                body()
            finally:
                graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    graph.held = {k: n - before[k] for k, n in CAPTURED.items()
                  if n != before[k]}
    return graph, warm
