"""Kind ``serve_moe``: a closed loop of static batches of an MLA +
DeepSeekMoE model (DeepSeek-V2) through
``repro_torch.launch.serve.serve_batch``, with the program's routing
recorded on the device for every batch (``bench/program_mla_moe.py``).

Set-up: the flash kernels built or loaded, the weights made on the device
from the seed, one warm-up batch at the cell's shapes, the routing record
on. The window: batch after batch, each started when the last returns,
until ``--seconds`` have passed; a batch started before then runs to its
end and the window ends with it. After each batch the record of its
choices is copied to the host (inside the window: the timed path and the
checked path are one). A traced run profiles the window's second batch
whole (prefill, graph capture and replays).

End-to-end: ``decode_tokens_per_s``, every token the window's batches
generated over the window's time; ``ttft_p95_ms``, the 95th percentile
(nearest rank) over every request of the time from its batch's call to the
end of its prefill, on the benchmark's clock.

``correct``: once the window has closed and the program's memory is freed,
the reference (``bench/reference/deepseek_v2.py``) runs over a sample of
the served requests drawn from the seed (prompt and served tokens), held
to the program's recorded routing at every MoE layer and position. ``gap``
is the widest gap by which a served token's logit lies below the held
reference's best at its position; ``route`` the largest share of the
program's expert choices that are not among the reference's own top-k at
the same layer input, taken apart by sampled request, by MoE layer and by
phase (the prefill's positions, the decode steps' positions), so that a
fault in one layer or in the decode path alone stands out of the sound
runs' flips near ties. ``compare`` is that check, and
``bench/calibrate_mla_moe.py`` reads its limits through it.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench import program, program_mla_moe as glue, traffic, weights_mla_moe
from bench.reference import compare as ref_compare
from bench.reference import deepseek_v2 as ref
from bench.reference.model import fp32_matmuls


def _p95(values) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def decode_hits(routing: np.ndarray, prompt: int, gen: int, n_experts: int):
    """Distinct experts each decode step's tokens chose, per MoE layer:
    routing (n_moe, B, T, k) -> (gen - 1, n_moe), steps at positions
    prompt .. prompt + gen - 2."""
    sel = routing[:, :, prompt:prompt + gen - 1, :].astype(np.int64)
    n_moe, _, steps, _ = sel.shape
    hit = np.zeros((n_moe, steps, n_experts), dtype=bool)
    hit[np.arange(n_moe)[:, None, None, None],
        np.arange(steps)[None, None, :, None], sel] = True
    return hit.sum(-1).T


def run(r) -> None:
    cfg, mix, dev = r.config, r.traffic, r.device
    if dev.type == "cuda":
        program.load_kernels(("flash_attention",))
    pcfg = glue.program_config(cfg)
    params = glue.params(pcfg, weights_mla_moe.make(cfg, r.seed, dev), dev)
    vocab, b, p, g = (cfg["vocab_size"], mix["batch"], mix["prompt_len"],
                      mix["gen_tokens"])
    record = glue.routing_record(pcfg, b, p + g, dev)
    glue.serve(pcfg, params, traffic.prompts(mix, vocab, r.seed, "warmup"), g,
               record)
    r.setup_done()

    batches = []
    t0 = time.perf_counter()
    while True:
        k = len(batches)
        prompts = traffic.prompts(mix, vocab, r.seed, k)
        traced = r.trace and k == 1
        if traced:
            with r.tracer() as tr:
                out = glue.serve(pcfg, params, prompts, g, record)
            r.traced = tr.result
        else:
            out = glue.serve(pcfg, params, prompts, g, record)
        served, stats, ttft, routing = out
        batches.append(dict(prompts=prompts, served=served, stats=stats,
                            ttft=ttft, routing=routing, traced=traced))
        if time.perf_counter() - t0 >= r.seconds and (not r.trace
                                                     or len(batches) >= 2):
            break
    window = time.perf_counter() - t0

    r.attempted = b * len(batches)
    r.e2e["decode_tokens_per_s"] = b * g * len(batches) / window
    r.e2e["ttft_p95_ms"] = 1e3 * _p95([x["ttft"] for x in batches
                                       for _ in range(b)])
    untraced = [x for x in batches if not x["traced"]]
    r.spans["serve"] = [x["stats"] for x in untraced]
    r.profiled = {"batch": b, "prompt": p, "gen": g,
                  "ttft_s": [x["ttft"] for x in untraced],
                  "decode_hits": [decode_hits(x["routing"], p, g,
                                              cfg["n_routed_experts"]).tolist()
                                  for x in untraced]}
    r.read_peak_memory()
    del params, record
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r.checks, per_request = compare(
        cfg, r.seed, [x["prompts"] for x in batches],
        [x["served"] for x in batches], [x["routing"] for x in batches],
        mix["check_requests"], dev)
    over = torch.zeros(len(per_request["gap"]), dtype=torch.bool)
    for k, limit in r.cell.limits.items():
        over |= per_request[k].cpu() > limit
    r.failed = int(over.sum())


def compare(cfg: dict, seed: int, prompts: list, served: list, routing: list,
            n: int, device, control: bool = False):
    """The check of a run's served requests: ``n`` of them drawn from the
    seed (request i is row i % B of batch i // B), each run through the
    reference over its prompt and served tokens, held to its recorded
    routing (``routing``: per batch (n_moe, B, T, k)). Returns ({number:
    value}, {number: per request}). ``route`` is the largest of the shares
    (by MoE layer, and over the prompt's positions or the decode steps'
    positions) of the program's choices outside the reference's own top-k;
    ``route_prefill`` and ``route_decode`` the largest of each phase's,
    ``route_mean`` the share over every layer and position. The second also
    holds ``route_shares`` (R, 2, n_moe), every share, and
    ``flip_deficits``, how far below the reference's own k-th router logit
    each disagreeing choice lies (the calibration's look at near ties).

    With ``control`` the control takes the program's place: the reference
    in float8 (``precision="fp8"``) runs with its own routing, and the
    numbers are those of the tokens it puts first at the same positions,
    with the float32 reference held to its routing."""
    b = len(prompts[0])
    rows = [(i // b, i % b) for i in traffic.sample(seed, b * len(prompts), n)]
    p = torch.as_tensor(np.stack([prompts[i][j] for i, j in rows]),
                        device=device).long()
    s = torch.as_tensor(np.stack([served[i][j] for i, j in rows]),
                        device=device).long()
    t = p.shape[1] + s.shape[1] - 1
    W = weights_mla_moe.drawer(cfg, seed, device)
    with fp32_matmuls():
        if control:
            ctl, held, _ = ref.served_logits(p, s, cfg, W, "fp8")
            chosen = ctl.argmax(-1)
            del ctl
        else:
            held = torch.as_tensor(np.stack([routing[i][:, j, :t]
                                             for i, j in rows], axis=1),
                                   device=device).long()
            chosen = s
        logits, own, deficit = ref.served_logits(p, s, cfg, W, "fp32", held)
    per_request = ref_compare.serve_numbers(ref_compare.token_gaps(logits, chosen))
    flipped = ~(held[..., :, None] == own[..., None, :]).any(-1)  # (n_moe, R, T, k)
    phases = (flipped[:, :, :p.shape[1]], flipped[:, :, p.shape[1]:])
    shares = torch.stack([f.float().mean(dim=(2, 3)) for f in phases])
    shares = shares.permute(2, 0, 1)                            # (R, 2, n_moe)
    per_request["route_shares"] = shares
    per_request["route"] = shares.amax(dim=(1, 2))
    per_request["route_prefill"] = shares[:, 0].amax(-1)
    per_request["route_decode"] = shares[:, 1].amax(-1)
    per_request["route_mean"] = flipped.float().mean(dim=(0, 2, 3))
    per_request["flip_deficits"] = deficit[flipped]
    return ({"gap": float(per_request["gap"].max()),
             "mean_gap": float(per_request["mean_gap"].mean()),
             **{k: float(per_request[k].max()) for k in (
                 "route", "route_prefill", "route_decode", "route_mean")}},
            per_request)
