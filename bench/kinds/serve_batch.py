"""Kind ``serve_batch``: a closed loop of static batches through
``repro_torch.launch.serve.serve_batch``.

Set-up: the cell's kernels built or loaded, the weights made on the device
from the seed, one warm-up batch at the cell's shapes. The window: batch
after batch, each started when the last returns, until ``--seconds`` have
passed; a batch started before then runs to its end and the window ends
with it. A traced run profiles the window's second batch whole (prefill,
graph capture and replays).

End-to-end: ``decode_tokens_per_s``, every token the window's batches
generated over the window's time; ``ttft_p95_ms``, the 95th percentile
(nearest rank) over every request of the time from its batch's call to the
end of the batch's prefill, on the benchmark's clock.

``correct``: once the window has closed and the program's memory is freed,
the reference runs over a sample of the served requests drawn from the
seed (prompt and served tokens); ``gap`` is the widest gap by which a
served token's logit lies below the reference's best at its position, and
``mean_gap`` the mean gap of the sampled served tokens. ``compare`` is that
check, and ``bench/calibrate.py`` reads its limits through it.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench import program, traffic, weights
from bench.reference import compare as ref_compare
from bench.reference import model


def _p95(values) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _drawer(cfg: dict, seed: int, device):
    specs = {s[0]: s for s in weights.leaf_specs(cfg)}
    return lambda name, layer: weights.draw(specs[name], seed, device,
                                            layer).float()


def run(r) -> None:
    cfg, mix, dev = r.config, r.traffic, r.device
    if dev.type == "cuda":
        program.load_kernels(("flash_attention", "decode_attention"))
    pcfg = program.program_config(cfg)
    params = program.params(pcfg, weights.make(cfg, r.seed, dev), dev)
    vocab, b, p, g = (cfg["vocab_size"], mix["batch"], mix["prompt_len"],
                      mix["gen_tokens"])
    program.serve(pcfg, params, traffic.prompts(mix, vocab, r.seed, "warmup"), g)
    r.setup_done()

    batches = []
    t0 = time.perf_counter()
    while True:
        k = len(batches)
        prompts = traffic.prompts(mix, vocab, r.seed, k)
        traced = r.trace and k == 1
        if traced:
            with r.tracer() as tr:
                served, stats, ttft = program.serve(pcfg, params, prompts, g)
            r.traced = tr.result
        else:
            served, stats, ttft = program.serve(pcfg, params, prompts, g)
        batches.append(dict(prompts=prompts, served=served, stats=stats,
                            ttft=ttft, traced=traced))
        if time.perf_counter() - t0 >= r.seconds and (not r.trace
                                                     or len(batches) >= 2):
            break
    window = time.perf_counter() - t0

    r.attempted = b * len(batches)
    r.e2e["decode_tokens_per_s"] = b * g * len(batches) / window
    r.e2e["ttft_p95_ms"] = 1e3 * _p95([x["ttft"] for x in batches
                                       for _ in range(b)])
    r.spans["serve"] = [x["stats"] for x in batches if not x["traced"]]
    r.profiled = {"batch": b, "prompt": p, "gen": g}
    r.read_peak_memory()
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r.checks, per_request = compare(cfg, r.seed, [x["prompts"] for x in batches],
                                    [x["served"] for x in batches],
                                    mix["check_requests"], dev)
    over = torch.zeros(len(per_request["gap"]), dtype=torch.bool)
    for k, limit in r.cell.limits.items():
        over |= per_request[k].cpu() > limit
    r.failed = int(over.sum())


def compare(cfg: dict, seed: int, prompts: list, served: list, n: int, device,
            control: bool = False):
    """The check of a run's served requests: ``n`` of them drawn from the
    seed (request i is row i % B of batch i // B), each run through the
    reference over its prompt and served tokens. Returns ({number: value},
    {number: per request}); with ``control`` the numbers are those of the
    tokens the control puts first at the same positions."""
    b = len(prompts[0])
    rows = [(i // b, i % b) for i in traffic.sample(seed, b * len(prompts), n)]
    p = torch.as_tensor(np.stack([prompts[i][j] for i, j in rows]),
                        device=device).long()
    s = torch.as_tensor(np.stack([served[i][j] for i, j in rows]),
                        device=device).long()
    W = _drawer(cfg, seed, device)
    with model.fp32_matmuls():
        ref = model.served_logits(p, s, cfg, W)
        gaps = (ref_compare.control_gaps(ref, model.served_logits(p, s, cfg, W, "fp8"))
                if control else ref_compare.token_gaps(ref, s))
    per_request = ref_compare.serve_numbers(gaps)
    return ({"gap": float(per_request["gap"].max()),
             "mean_gap": float(per_request["mean_gap"].mean())}, per_request)
