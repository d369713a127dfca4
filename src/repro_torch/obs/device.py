"""Spans and counters on the device path: the serving loop, the training
loop and the model's parts, behind the same one switch as the rest of
``obs`` (the ambient recorder, ``obs.current()``).

* ``span(name)`` is a context manager. With an enabled recorder it opens
  ``torch.profiler.record_function("repro_torch." + name)``: under an
  active ``torch.profiler`` session the range lands in the profiler's event
  list on the same clock as the device's kernels, so a trace shows the
  program's ranges over its kernels with no second clock to line up.
  Ranges nest: a span's parent is the range that encloses it.
* ``count(name, n=1)`` adds ``n`` to the recorder's exact integer counter
  ``name``.

Disabled (``obs.NULL``, the default), each call reads ``obs.current()``,
branches and returns: no ``record_function``, no recorder call, nothing
allocated (``span`` hands back one shared no-op context).

Host code inside a region that a CUDA graph captures runs once, at the
capture. A replay runs no host code, so a span opened in captured code
appears at the capture and never in a replay, and a counter there counts
the capture, not the replays. The program counts replays outside the
captured region (``serve.decode.steps``, ``train.graph.replays``). To
name a replay's kernels, take the labels of the kernels at the same
positions in the step's eager run: the decode graph's warm-up step
(``serve.capture.warmup``) or the train graph's first call. Under remat a
checkpointed branch's range opens again in the backward's recompute.

The spans (each ``repro_torch.`` + the name):

* ``serve.batch`` (``launch/serve.py::serve_batch``), holding
  ``serve.prefill`` (the prefill, the first token's argmax and the sync:
  the program's first-token stamp), ``serve.capture`` (``DecodeGraph``:
  the caches' copy, the warm-up step, the capture) and its
  ``serve.capture.warmup`` (the eager warm-up step), ``serve.decode`` (the
  replays, or the CPU's eager steps, to the sync), ``serve.release`` and
  ``serve.fetch`` (the tokens to the host);
* ``train.feed`` (the batch to the device in ``train_loop``; the copies
  into ``TrainGraph``'s static buffers), ``train.step``, ``train.replay``
  and ``train.capture`` (``launch/train.py::TrainGraph``);
  ``train.forward``, ``train.backward`` and ``train.optimizer``
  (``make_train_step``'s step: the loss, ``torch.autograd.grad``, AdamW's
  norm, clip and update);
* ``model.embed``, ``model.attn``, ``model.mlp`` or ``model.moe`` and
  ``model.head`` (``models/decoder_lm.py``; the recurrent mixers, the
  encoder-decoder and the VLM families have none).

The counters are ``serve.decode.steps`` (``serve_batch``, once a call, on
the graph and the eager path alike) and ``train.graph.replays`` (one per
replay): the denominators of per-step numbers.

To see the ranges over the kernels, install a recorder, run under the
profiler and open the Chrome trace (in Perfetto or ``chrome://tracing``)::

    with obs.recording(obs.Recorder()) as rec, torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tokens, stats = serve_batch(cfg, params, {"tokens": prompts}, 64)
    prof.export_chrome_trace("serve.trace.json")
    rec.metrics.snapshot()["counters"]    # {"serve.decode.steps": 63}
"""
from __future__ import annotations

import contextlib

from torch.profiler import record_function

from repro_torch import obs

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str | None):
    """``with span("serve.prefill"): ...``: a ``record_function`` range
    named ``repro_torch.<name>`` when recording is on. ``span(None)`` opens
    nothing (a part that has no span of its own)."""
    if name is None or not obs.current().enabled:
        return _OFF
    return record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the ambient recorder's counter ``name``."""
    rec = obs.current()
    if rec.enabled:
        rec.metrics.inc(name, n)
