"""DeepSeek-V2-Lite (``get_config("deepseek-v2-lite")``, a config of the
port alone) against the benchmark's plain reference
``bench/reference/deepseek_v2.py``, on the CPU in fp32.

The reference follows Hugging Face's ``modeling_deepseek``; the port is
held to it at a reduced width with seeded weights (``bench/weights_mla_moe``
leaves, handed to the program by ``bench/program_mla_moe``): the full
forward, the prefill and then absorbed decode steps against the
reference's full forward, MLA through the flash forward's plain version,
YaRN's inverse frequencies and softmax scale against HF's formulas at the
published widths, unnormalized gates, the dropless path under a routing
that sends every token to one expert (where the capacity path drops), the
reference held to its own routing, and the benchmark kind's ``compare`` on
a tiny cell, the float8 control's too."""
import contextlib
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench import program_mla_moe as glue  # noqa: E402
from bench import weights_mla_moe  # noqa: E402
from bench.kinds import serve_moe  # noqa: E402
from bench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import decoder_lm as tdlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

# plain fp32 on both sides, summed in other orders: tests/test_kernels.py's
# model-level fp32 tolerance
TOL = 2e-4
SEED = 2 ** 31 + 7
FULL = json.loads((ROOT / "bench" / "configs" / "deepseek-v2-lite.json")
                  .read_text())


def small(**over) -> dict:
    """The configuration file at a reduced width, fp32: 3 layers (one
    dense), 4 heads of nope 16 + rope 16, v 16, latent 32, 8 experts top-3
    of width 32 with 2 shared; YaRN over 16 original positions, so the
    prompts pass them."""
    c = dict(FULL)
    c.update(hidden_size=64, vocab_size=256, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, kv_lora_rank=32,
             intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=3, torch_dtype="float32")
    c["rope_scaling"] = dict(c["rope_scaling"], factor=4,
                             original_max_position_embeddings=16)
    c.update(over)
    return c


@contextlib.contextmanager
def knobs(**flags):
    old = {k: tcommon.RUNTIME[k] for k in flags}
    tcommon.RUNTIME.update(flags)
    try:
        yield
    finally:
        tcommon.RUNTIME.update(old)


def _program(cfg):
    pcfg = glue.program_config(cfg)
    return pcfg, glue.params(pcfg, weights_mla_moe.make(cfg, SEED, "cpu"), "cpu")


def _tokens(cfg, shape, seed=0):
    return torch.randint(0, cfg["vocab_size"], shape,
                         generator=torch.Generator().manual_seed(seed))


def test_config_is_the_published_one():
    cfg = get_config("deepseek-v2-lite")
    assert "deepseek-v2-lite" not in ARCHS      # the reference has none
    assert glue.program_config(FULL) == cfg
    assert cfg.n_layers == 27 and cfg.vocab_size == 102_400 and cfg.mla_absorb
    moe = cfg.segments[1].layers[0].moe
    assert (moe.n_experts, moe.top_k, moe.d_ff_expert, moe.n_shared) == (64, 6, 1408, 2)
    assert moe.dropless and not moe.norm_topk_prob
    mla = cfg.segments[0].layers[0].mla
    assert mla.q_lora_rank is None and mla.rope_scaling.factor == 40.0
    assert FULL["reduced"] == []
    params = tdlm.init_params(cfg, device="meta")
    assert round(tdlm.param_count(params) / 1e9, 2) == 15.71
    assert sum(int(np.prod(s[1])) for s in weights_mla_moe.leaf_specs(FULL)) \
        == tdlm.param_count(params)


def test_yarn_against_hf_formulas():
    """DeepseekV2YarnRotaryEmbedding at the published widths, worked out
    in float64 from HF's formulas: pairs below 10 keep base 10,000, pairs
    from 23 up are divided by 40, a linear ramp between; cos and sin
    unscaled (mscale = mscale_all_dim); softmax scale 192^-0.5 x 1.5896."""
    dim, base, factor = 64, 10_000.0, 40.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = 1.0 / base ** (2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / factor * ramp + extra * (1 - ramp))
    spec = get_config("deepseek-v2-lite").segments[0].layers[0].mla
    got = tcommon.yarn_freqs(dim, base, spec.rope_scaling)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[9] == tcommon.rope_freqs(dim, base)[9]
    np.testing.assert_allclose(got[23:].numpy(), np.array(want[23:]), rtol=1e-6)
    inv, m = ref.rope_tables(FULL, "cpu")
    torch.testing.assert_close(inv, got, rtol=0, atol=0)
    assert m == tcommon.rope_scale(spec.rope_scaling) == 1.0
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert tattn.mla_softmax_scale(spec) == pytest.approx(
        192 ** -0.5 * mscale * mscale, rel=1e-12)
    assert mscale * mscale == pytest.approx(1.5896, abs=1e-4)
    assert ref.softmax_scale(FULL) == tattn.mla_softmax_scale(spec)


def test_full_forward_matches_reference():
    cfg = small()
    pcfg, params = _program(cfg)
    tokens = _tokens(cfg, (2, 24))
    W = weights_mla_moe.drawer(cfg, SEED, "cpu")
    with torch.no_grad():
        got, _, _ = tdlm.forward(params, pcfg, tokens=tokens)
        x, _, _ = ref.forward(tokens, cfg, W)
    want = x @ W("lm_head", None)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_then_absorbed_decode_matches_reference(flash):
    """The serving path: prefill (with ``use_flash``, MLA through the flash
    forward's plain version at D 32, v widened), then absorbed decode steps
    fed the served tokens, against the reference's full forward; the
    device routing record against the reference's own choices."""
    cfg = small()
    pcfg, params = _program(cfg)
    prompts, served = _tokens(cfg, (2, 20), 1), _tokens(cfg, (2, 6), 2)
    p, g = prompts.shape[1], served.shape[1]
    record = glue.routing_record(pcfg, 2, p + g, "cpu")
    out = []
    with knobs(use_flash=flash), torch.no_grad(), \
            tmlp.record_routing_on_device(record):
        last, caches = tdlm.prefill(params, pcfg, tokens=prompts, max_len=p + g)
        out.append(last[:, -1])
        for i in range(g - 1):
            pos = torch.full((), p + i, dtype=torch.int32)
            logits, caches = tdlm.decode_step(params, pcfg, served[:, i:i + 1],
                                              pos, caches)
            out.append(logits[:, -1])
    got = torch.stack(out, dim=1)
    want, own, _ = ref.served_logits(prompts, served, cfg,
                                     weights_mla_moe.drawer(cfg, SEED, "cpu"))
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    rec = record.experts[:, :, :p + g - 1].long()
    assert torch.equal(rec.sort(-1).values, own.sort(-1).values)


def test_mla_flash_path_matches_einsum():
    """``mla_full`` with ``use_flash`` (no gradient: the flash forward's
    plain version at nope + rope, the YaRN scale handed over) against the
    einsum path."""
    cfg = small()
    pcfg, params = _program(cfg)
    spec = pcfg.segments[0].layers[0].mla
    p = params["segments"][0][0]["mla"]
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(20, dtype=torch.int32)[None].expand(2, 20)
    with torch.no_grad():
        plain = tattn.mla_full(p, spec, x, pos)
        with knobs(use_flash=True):
            flash = tattn.mla_full(p, spec, x, pos)
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=1e-5)


def test_gates_are_unnormalized():
    spec = get_config("deepseek-v2-lite").segments[1].layers[0].moe
    probs = torch.tensor([[0.3, 0.2, 0.1]])
    assert torch.equal(tmlp._gates(probs, spec), probs)
    scaled = dataclasses.replace(spec, routed_scaling_factor=2.5)
    assert torch.equal(tmlp._gates(probs, scaled), probs * 2.5)
    normed = dataclasses.replace(spec, norm_topk_prob=True)
    torch.testing.assert_close(tmlp._gates(probs, normed), probs / 0.6)
    # the reference's own rule (MoESpec's defaults) is kept
    base = MoESpec(n_experts=3, top_k=3, d_ff_expert=4)
    torch.testing.assert_close(tmlp._gates(probs, base), probs / 0.6)


def _skewed_moe(cfg):
    """Layer 1's MoE params with a router that sends every token to expert
    0 first (and 1, 2 next)."""
    pcfg, params = _program(cfg)
    p = {k: (v[0] if isinstance(v, torch.Tensor) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["segments"][1][0]["moe"].items()}
    router = torch.zeros_like(p["router"])
    router[:, :3] = torch.tensor([3.0, 2.0, 1.0])
    p["router"] = router
    return pcfg.segments[1].layers[0].moe, p


def test_dropless_path_drops_nothing_under_imbalance():
    cfg = small()
    spec, p = _skewed_moe(cfg)
    x = torch.rand(2, 300, 64, generator=torch.Generator().manual_seed(4)) + 0.5
    with obs.recording(obs.Recorder()) as rec, torch.no_grad(), \
            tmlp.record_routing() as routing:
        y, _ = tmlp.moe(p, spec, x, "silu")
        capped, _ = tmlp.moe(p, dataclasses.replace(spec, dropless=False), x,
                             "silu")
    counters = rec.metrics.snapshot()["counters"]
    assert counters["moe.choices"] == 2 * 2 * 300 * 3
    dropped = int((~routing[1][1]).sum())
    assert dropped > 0 and counters["moe.dropped"] == dropped
    assert routing[0][1].all()
    assert bool((routing[0][0][..., 0] == 0).all())
    W = weights_mla_moe.drawer(cfg, SEED, "cpu")

    def skewed(name, layer):
        return p["router"] if name == "layers.moe.router" else W(name, layer)
    with torch.no_grad():
        want, _, _ = ref.moe(x, cfg, skewed, 0, "fp32")
    torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)
    assert (capped - want).abs().max() > 1e-2


def test_reference_held_to_its_own_routing_is_unheld():
    cfg = small()
    W = weights_mla_moe.drawer(cfg, SEED, "cpu")
    prompts, served = _tokens(cfg, (2, 20), 5), _tokens(cfg, (2, 4), 6)
    free, own, _ = ref.served_logits(prompts, served, cfg, W)
    held, own2, deficit = ref.served_logits(prompts, served, cfg, W, held=own)
    torch.testing.assert_close(held, free, rtol=1e-6, atol=1e-6)
    assert torch.equal(own2, own) and bool((deficit <= 0).all())
    other = own.roll(1, dims=-1).clone()
    other[..., 0] = (other[..., 0] + 1) % cfg["n_routed_experts"]
    moved, _, _ = ref.served_logits(prompts, served, cfg, W, held=other)
    assert (moved - free).abs().max() > 1e-3


def _tiny_cell(dtype):
    full = harness.cell(harness.load_spec(), "deepseek-v2-lite.serve-8k")
    mix = dict(full.traffic, batch=2, prompt_len=20, gen_tokens=5,
               check_requests=2)
    return harness.Cell(name=full.name, config=small(torch_dtype=dtype),
                        traffic=mix, limits=full.limits,
                        end_to_end=full.end_to_end, per_layer=full.per_layer)


def test_kind_runs_and_compares_on_a_tiny_cell():
    """The kind end to end on the CPU (two batches, untraced): the numbers
    it compares; fp32 serves the reference's own tokens and routing. Then
    ``compare`` on the same requests with the float8 control in the
    program's place: its tokens and routing move away from the reference."""
    c = _tiny_cell("float32")
    r = harness.execute(c, SEED, 0.0, False, "cpu")
    assert r.attempted == 2 and r.failed == 0 and harness.correct(r)
    assert r.checks["gap"] < 1e-4 and r.checks["route"] == 0.0
    out = harness.result(r)
    assert set(out["metrics"]) == {"setup_s", "decode_tokens_per_s",
                                   "ttft_p95_ms"}
    pcfg, params = _program(c.config)
    mix = c.traffic
    prompts = serve_moe.traffic.prompts(mix, 256, SEED, 0)
    record = glue.routing_record(pcfg, 2, 25, "cpu")
    served, _, _, routing = glue.serve(pcfg, params, prompts, 5, record)
    args = (c.config, SEED, [prompts], [served], [routing], 2, "cpu")
    sound, _ = serve_moe.compare(*args)
    ctl, per = serve_moe.compare(*args, control=True)
    assert sound["route"] == 0.0 and sound["gap"] < 1e-4
    assert ctl["route"] > 0.0 and ctl["gap"] > 10 * sound["gap"]
    assert per["route"].shape == (2,)


@pytest.mark.parametrize("fault", ["decode_every_layer", "one_layer"])
def test_kind_fails_a_planted_routing_fault(fault):
    """A routing fault planted in the program (its top-k taken from ranks
    2 .. k+1: in the decode steps alone, or in one MoE layer alone) makes
    the kind's run not ``correct`` through ``route``, though the fault
    touches few of the choices of a request (a decode fault 4 positions of
    24)."""
    from bench import calibrate_mla_moe as cal
    c = _tiny_cell("float32")
    n_moe = c.config["num_hidden_layers"] - c.config["first_k_dense_replace"]
    with cal.planted(n_moe, *cal.faults(n_moe)[fault]):
        r = harness.execute(c, SEED, 0.0, False, "cpu")
    assert r.checks["route"] > c.limits["route"] and r.failed > 0
    assert not harness.correct(r)
    phase = "route_decode" if fault == "decode_every_layer" else "route_prefill"
    assert r.checks[phase] == r.checks["route"]


def test_decode_hits_counts_distinct_experts():
    routing = np.zeros((2, 2, 6, 2), dtype=np.uint8)
    routing[0, :, 4] = [[1, 2], [2, 3]]
    routing[1, :, 4] = [[5, 5], [5, 5]]
    hits = serve_moe.decode_hits(routing, prompt=4, gen=3, n_experts=8)
    assert hits.tolist() == [[3, 1], [1, 1]]
