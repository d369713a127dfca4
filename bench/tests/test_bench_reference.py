"""The benchmark's plain reference against the program's CPU path at
``reduce_for_smoke`` sizes, in float32, with a sliding window shorter
than the sequence and without one: prefill and decode logits, and the
checked training steps."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import program, traffic, weights
from bench.reference import compare, model
from bench.reference import train as ref_train
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import decoder_lm

BENCH = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def smoke_config(name: str, **over) -> dict:
    """The configuration file at ``reduce_for_smoke``'s sizes, float32."""
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c.update(hidden_size=32, vocab_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, head_dim=16,
             intermediate_size=64, torch_dtype="float32")
    c.update(over)
    return c


def test_full_config_is_the_repo_config_with_the_published_window():
    cfg = json.loads((BENCH / "configs" / "phi3-mini-3.8b.json").read_text())
    assert cfg["sliding_window"] == 2047
    assert program.program_config(cfg).segments[0].layers[0].attn.window == 2047
    # the repo's phi3-mini attends the whole context; all else is the same
    full = dict(cfg, sliding_window=None)
    assert program.program_config(full) == get_config("phi3-mini-3.8b")
    smoke = program.program_config(smoke_config("phi3-mini-3.8b",
                                                sliding_window=None))
    # reduce_for_smoke also zeroes the VLM's patch count, which no decoder
    # LM reads
    assert smoke == dataclasses.replace(
        reduce_for_smoke(get_config("phi3-mini-3.8b")), n_patches=256)


def _drawer(cfg, seed):
    specs = {s[0]: s for s in weights.leaf_specs(cfg)}
    return lambda name, layer: weights.draw(specs[name], seed, "cpu", layer).float()


def _program_logits(cfg, params, prompts, served):
    """The program's prefill, then its decode steps fed the served tokens:
    the logits each served token was chosen from, (R, G, V)."""
    pcfg = program.program_config(cfg)
    p = prompts.shape[1]
    last, caches = decoder_lm.prefill(params, pcfg, tokens=prompts,
                                      max_len=p + served.shape[1])
    out = [last[:, -1]]
    for i in range(served.shape[1] - 1):
        logits, caches = decoder_lm.decode_step(params, pcfg, served[:, i:i + 1],
                                                p + i, caches)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("window", [None, 6, 2047])
def test_prefill_and_decode_logits(window):
    cfg = smoke_config("phi3-mini-3.8b", sliding_window=window)
    pcfg = program.program_config(cfg)
    params = program.params(pcfg, weights.make(cfg, 5, "cpu"), "cpu")
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, 256, (2, 16), generator=gen)
    served = torch.randint(0, 256, (2, 5), generator=gen)
    with torch.no_grad():
        got = _program_logits(cfg, params, prompts, served)
    want = model.served_logits(prompts, served, cfg, _drawer(cfg, 5))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if window == 6:     # the window changes what the reference computes
        wide = model.served_logits(prompts, served, dict(cfg, sliding_window=None),
                                   _drawer(cfg, 5))
        assert (wide - want).abs().max() > 1e-2


@pytest.mark.parametrize("window", [None, 6])
def test_train_steps(window):
    """The checked steps: losses, the first gradient per leaf, the change."""
    cfg = smoke_config("phi3-mini-3.8b", sliding_window=window)
    steps = 3
    mix = json.loads((BENCH / "traffic" / "train-4k.json").read_text())
    mix.update(batch=2, seq_len=16)
    specs = {s[0]: s for s in weights.leaf_specs(cfg)}
    names = [(n, s[1][0] if n.startswith("layers.") else 0) for n, s in specs.items()]
    pcfg = program.program_config(cfg)
    tr = program.Trainer(pcfg, mix["optimizer"],
                         program.params(pcfg, weights.make(cfg, 3, "cpu"), "cpu"),
                         "cpu")
    prog = {"loss": []}
    batches = [traffic.train_batch(mix, 256, 3, k) for k in range(steps)]
    for k, (tokens, labels) in enumerate(batches):
        prog["loss"].append(float(tr.step(tokens, labels)["loss"]))
        if k == 0:
            prog["grad"] = tr.first_grad_norms(names)
    prog["change"] = tr.change_norms(
        names, lambda n, i: weights.draw(specs[n], 3, "cpu", i))
    tr.close()
    ref = ref_train.readings(
        cfg, mix["optimizer"], lambda spec, i: weights.draw(spec, 3, "cpu", i),
        [tuple(torch.as_tensor(a).long() for a in b) for b in batches])
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss"] < 1e-5
    assert numbers["grad"] < 1e-4
    assert numbers["change"] < 1e-3
    assert numbers["left_out"] == []
    assert set(prog["grad"]) == set(ref["grad"])


def test_gaps():
    ref = torch.tensor([[[0.0, 2.0, 1.0], [3.0, 0.0, 2.5]]])
    assert compare.token_gaps(ref, torch.tensor([[1, 0]])).tolist() == [[0.0, 0.0]]
    n = compare.serve_numbers(compare.token_gaps(ref, torch.tensor([[2, 2]])))
    assert n["gap"].tolist() == [1.0] and n["mean_gap"].tolist() == [0.75]
    ctl = torch.tensor([[[0.0, 1.0, 5.0], [1.0, 0.0, 0.0]]])
    assert compare.control_gaps(ref, ctl).tolist() == [[1.0, 0.0]]


def test_train_numbers_leave_out_leaves_with_no_gradient():
    ref = {"loss": [2.0], "grad": {"a": 1.0, "b": 2.0, "c": 0.0},
           "grad_raw": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 1.0, "c": 0.0}}
    prog = {"loss": [2.002], "grad": {"a": 1.1, "b": 2.0, "c": 5.0},
            "change": {"a": 1.0, "b": 0.5, "c": 3.0}}
    n = compare.train_numbers(prog, ref)
    assert n["loss"] == pytest.approx(1e-3)
    assert n["grad"] == pytest.approx(0.1 / 1.5)
    assert n["change"] == pytest.approx(0.5)
    assert n["left_out"] == ["c"]
    assert np.isfinite(n["grad"])
