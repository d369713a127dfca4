"""``correct`` comes out false when the timed path is broken underneath: a
whole run of each cell, small and on the CPU (the look for a card skipped),
with the program patched to make one fault a cell can have, against the
cell's own limits; and true when nothing is broken.

Serving: a decode step that leaves its state (the KV caches) unchanged,
half of the batch left out (its tokens never produced), one token altered
where it is produced. Training: a step that leaves its state unchanged,
half of each batch left out of the loss (the mean taken over the rest).
One card runs no exchange between chips, so that fault does not apply.
Every request of the window is compared (``check_requests``), so a fault
in any row shows. Float32 models, where the program agrees with the
reference to rounding, so that a failure is the fault's."""
import contextlib

import pytest
import torch

from bench import harness
from bench.tests import tiny
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import decoder_lm
from repro_torch.training import train_step as ts

SERVE = ["phi3-mini-3.8b.decode-4k"]
TRAIN = ["phi3-mini-3.8b.16-layers.train-4k"]
SEED = 2 ** 31 + 101
torch.set_num_threads(2)


@contextlib.contextmanager
def patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def cache_unchanged():
    orig = attn_mod.attn_decode

    def attn_decode(p, spec, x, pos, cache):
        y, _ = orig(p, spec, x, pos, {k: v.clone() for k, v in cache.items()})
        return y, cache
    return patched(attn_mod, "attn_decode", attn_decode)


def _wrap_step(change):
    orig = serve_mod.make_decode_step

    def make_decode_step(cfg, api=None, greedy=True):
        fn = orig(cfg, api, greedy)
        calls = [0]

        def step(params, token, pos, caches):
            nxt, caches = fn(params, token, pos, caches)
            calls[0] += 1
            return change(nxt.clone(), calls[0], cfg), caches
        return step
    return patched(serve_mod, "make_decode_step", make_decode_step)


def half_batch_left_out():
    def change(nxt, _, __):
        nxt[nxt.shape[0] // 2:] = 0
        return nxt
    return _wrap_step(change)


def token_altered():
    def change(nxt, call, cfg):
        if call == 3:
            nxt[0] = (nxt[0] + 1) % cfg.vocab_size
        return nxt
    return _wrap_step(change)


def state_unchanged_train():
    def adamw_update_(cfg, grads, state, params):
        return {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}
    return patched(ts, "adamw_update_", adamw_update_)


def half_batch_train():
    orig = decoder_lm.loss_and_metrics

    def loss_and_metrics(params, cfg, batch):
        labels = batch["labels"].clone()
        labels[labels.shape[0] // 2:] = -100
        return orig(params, cfg, dict(batch, labels=labels))
    return patched(decoder_lm, "loss_and_metrics", loss_and_metrics)


FAULTS = {"cache_unchanged": cache_unchanged,
          "half_batch_left_out": half_batch_left_out,
          "token_altered": token_altered}
TRAIN_FAULTS = {"state_unchanged": state_unchanged_train,
                "half_batch_left_out": half_batch_train}


def _run(workload, fault=None):
    c = tiny.cell(workload, dtype="float32", hidden=1024, batch=4,
                  **({} if "train" in workload else {"check_requests": 10 ** 6}))
    with fault() if fault else contextlib.nullcontext():
        r = harness.execute(c, SEED, 0.0, False, "cpu")
    return harness.correct(r), r.checks


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_a_sound_run_is_correct(workload):
    ok, checks = _run(workload)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", SERVE)
def test_a_broken_decode_is_not_correct(workload, fault):
    ok, checks = _run(workload, FAULTS[fault])
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("workload", TRAIN)
def test_a_broken_training_step_is_not_correct(workload, fault):
    ok, checks = _run(workload, TRAIN_FAULTS[fault])
    assert not ok, checks
