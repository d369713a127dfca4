"""The device path's spans and counters (``repro_torch/obs/device.py``) on
the CPU, over reduced phi3-mini (a dense model, two layers stacked in one
segment): ``serve_batch``, a ``make_train_step`` step and a step of
``train_loop``.

* Disabled (``obs.NULL``, the default), no ``record_function`` is entered
  and the recorder is not called.
* Under ``obs.recording(obs.Recorder())`` and a CPU ``torch.profiler``
  session the profiler's events hold the spans, nested as the program
  opens them: ``serve.batch`` holds ``serve.prefill``, which holds each
  layer's ``model.attn``; in ``train_loop`` ``train.feed`` runs before
  ``train.forward``, before ``train.backward``, before
  ``train.optimizer``. ``serve.decode.steps`` counts the decode steps.
* Recording changes no number: the served tokens and the step's metrics
  and state are bit for bit those of a run with recording off.

The captured paths (``DecodeGraph``, ``TrainGraph``) run on the card only.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from repro_torch import obs
from repro_torch._tree import leaves
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import get_api
from repro_torch.obs import device as odev
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (device_batch, init_train_state,
                                             make_train_step)

GEN = 5
PROMPT = 12


@pytest.fixture(scope="module")
def cfg():
    c = reduce_for_smoke(get_config("phi3-mini-3.8b"))
    assert c.n_layers == 2 and c.segments[0].count == 2
    return c


@pytest.fixture(scope="module")
def params(cfg):
    return get_api(cfg).init_params(cfg, seed=3, device="cpu")


def _prompts(cfg, seed=0):
    return make_batch(cfg, SyntheticConfig(global_batch=2, seq_len=PROMPT,
                                           seed=seed), 0)


def _serve(cfg, params):
    return tserve.serve_batch(cfg, params, _prompts(cfg), GEN,
                              log=lambda *_: None)


def _train(cfg, remat=False, steps=2):
    """``steps`` donating steps from the same fresh state: (metrics as
    floats per step, the final state's leaves)."""
    c = dataclasses.replace(cfg, remat=remat)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(c, 1, opt, "cpu")
    step = make_train_step(c, opt, donate=True)
    out = []
    for k in range(steps):
        batch = device_batch(c, make_batch(c, SyntheticConfig(
            global_batch=2, seq_len=16, seed=2), k), "cpu")
        state, metrics = step(state, batch)
        out.append({n: float(v) for n, v in metrics.items()})
    return out, [t.clone() for t in leaves(state)]


def _loop(cfg, remat=False):
    """One step of ``train_loop`` on the CPU, which feeds the batch and
    runs ``make_train_step``'s plain step."""
    c = dataclasses.replace(cfg, remat=remat)
    return train_loop(c, steps=1, global_batch=2, seq_len=16, device="cpu",
                      log=lambda *_: None)


def _spans(prof):
    """[(name without the prefix, start ns, end ns)] of the program's
    ranges, by start."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(odev.PREFIX):
            out.append((ev.name()[len(odev.PREFIX):], ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return sorted(out, key=lambda s: s[1])


def _recorded(fn):
    """``fn()`` under a fresh recorder and a CPU profiler: (its result, the
    spans, the recorder's counters)."""
    rec = obs.Recorder()
    with obs.recording(rec), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof), rec.metrics.snapshot()["counters"]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_disabled_enters_no_range_and_calls_no_recorder(cfg, params,
                                                        monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(odev, "record_function", counting)
    assert obs.current() is obs.NULL
    before = obs.NULL.calls
    _serve(cfg, params)
    _train(cfg, remat=True, steps=1)
    assert entered == [] and obs.NULL.calls == before
    # the same paths under a recorder do enter it
    with obs.recording(obs.Recorder()):
        _serve(cfg, params)
    assert "repro_torch.serve.batch" in entered


def test_span_none_and_count_off_do_nothing(monkeypatch):
    monkeypatch.setattr(odev, "record_function", None)   # would raise
    with obs.recording(obs.Recorder()):
        with odev.span(None):
            pass
    before = obs.NULL.calls
    with odev.span("serve.batch"):
        odev.count("serve.decode.steps", 3)
    assert obs.NULL.calls == before


def test_serving_spans_nest_and_count_the_steps(cfg, params):
    (tokens, stats), spans, counters = _recorded(lambda: _serve(cfg, params))
    names = {s[0] for s in spans}
    assert {"serve.batch", "serve.prefill", "serve.decode", "serve.fetch",
            "model.embed", "model.attn", "model.mlp", "model.head"} <= names
    # the CPU decodes eagerly: no graph to capture or release
    assert not names & {"serve.capture", "serve.capture.warmup",
                        "serve.release"}
    (batch,) = _named(spans, "serve.batch")
    (prefill,) = _named(spans, "serve.prefill")
    (decode,) = _named(spans, "serve.decode")
    assert _inside(prefill, batch) and _inside(decode, batch)
    assert prefill[2] <= decode[1]
    n_layers = cfg.n_layers
    for part in ("model.attn", "model.mlp"):
        got = _named(spans, part)
        assert len(got) == n_layers * GEN       # the prefill and each step
        assert sum(_inside(s, prefill) for s in got) == n_layers
        assert sum(_inside(s, decode) for s in got) == n_layers * (GEN - 1)
    for s in spans:
        assert s[0] == "serve.batch" or _inside(s, batch), s
    assert counters == {"serve.decode.steps": GEN - 1}
    assert stats["decode_steps"] == GEN - 1 and tokens.shape == (2, GEN)


@pytest.mark.parametrize("remat", [False, True])
def test_training_spans_run_in_order(cfg, remat):
    _, spans, counters = _recorded(lambda: _loop(cfg, remat=remat))
    (feed,) = _named(spans, "train.feed")
    (fwd,) = _named(spans, "train.forward")
    (bwd,) = _named(spans, "train.backward")
    (opt,) = _named(spans, "train.optimizer")
    assert feed[2] <= fwd[1] and fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    mlp = _named(spans, "model.mlp")
    assert sum(_inside(s, fwd) for s in mlp) == cfg.n_layers
    # remat recomputes each block inside the backward, where its range
    # opens again
    assert sum(_inside(s, bwd) for s in mlp) == (cfg.n_layers if remat else 0)
    assert _named(spans, "model.head") and _named(spans, "model.embed")
    assert all(_inside(s, fwd) or _inside(s, bwd)
               for s in spans if s[0].startswith("model."))
    assert counters == {}


def test_recording_changes_no_number(cfg, params):
    tokens, stats = _serve(cfg, params)
    (tokens_rec, stats_rec), _, _ = _recorded(lambda: _serve(cfg, params))
    np.testing.assert_array_equal(tokens, tokens_rec)
    assert stats["decode_steps"] == stats_rec["decode_steps"]
    for remat in (False, True):
        metrics, state = _train(cfg, remat=remat)
        (metrics_rec, state_rec), _, _ = _recorded(
            lambda: _train(cfg, remat=remat))
        assert metrics == metrics_rec
        assert all(torch.equal(a, b) for a, b in zip(state, state_rec))


def test_perf_counter_clock():
    t = tserve._clock(torch.device("cpu"))
    assert abs(time.perf_counter() - t) < 5.0
