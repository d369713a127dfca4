"""Serving launcher — batched prefill + greedy decode over the registry API.
Port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.models import common as cc
from repro_torch.models.registry import get_api
from repro_torch.training.train_step import make_decode_step, make_prefill


def _clock(device: torch.device) -> float:
    """Host clock after the device has finished the work queued so far (the
    reference's ``block_until_ready``): without it a CUDA run would time
    only the launches."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


@torch.no_grad()
def serve_batch(cfg, params, batch: dict, gen_tokens: int, log=print):
    """Prefill the prompt batch, then greedy-decode gen_tokens. Returns
    (generated (B, gen) int32 numpy, stats dict).

    Runs where ``params`` lie. On a CUDA device it turns on
    ``RUNTIME["use_flash"]`` (the hand-written attention kernels), as the
    reference does on its accelerator. Each decode step writes the new token
    into the prefill-time caches in place (the reference donates them).
    ``stats`` has the reference's keys; ``backend`` is the device type."""
    device = _device.of(params)
    if device.type == "cuda":
        cc.RUNTIME["use_flash"] = True
    api = get_api(cfg)
    prefill_fn = make_prefill(cfg, api)
    decode_fn = make_decode_step(cfg, api)
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=device)
    b, s = tokens.shape
    max_len = s + gen_tokens

    t0 = _clock(device)
    last_logits, caches = prefill_fn(params, {"tokens": tokens}, max_len)
    token = torch.argmax(last_logits[:, -1], dim=-1).to(torch.int32)[:, None]
    t_prefill = _clock(device) - t0

    out = [token]
    t0 = _clock(device)
    for i in range(gen_tokens - 1):
        token, caches = decode_fn(params, token, s + i, caches)
        out.append(token)
    t_decode = _clock(device) - t0
    gen = torch.cat(out, dim=1)
    decode_steps = gen_tokens - 1
    stats = {
        "batch": b,
        "prompt_tokens": s,
        "gen_tokens": gen_tokens,
        "prefill_s": t_prefill,
        "prefill_tokens": b * s,
        "prefill_tokens_per_s": b * s / max(t_prefill, 1e-9),
        "decode_s": t_decode,
        "decode_steps": decode_steps,
        "decode_tokens": b * decode_steps,
        "tokens_per_s": b * decode_steps / max(t_decode, 1e-9),
        "decode_s_per_token": (t_decode / max(b * decode_steps, 1)),
        "backend": device.type,
    }
    log(f"prefill {s} toks x{b}: {t_prefill:.2f}s; "
        f"decode {decode_steps} steps: {t_decode:.2f}s "
        f"({stats['tokens_per_s']:.1f} tok/s)")
    return gen.cpu().numpy(), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
        cfg = dataclasses.replace(cfg, remat=False)
    api = get_api(cfg)
    params = api.init_params(cfg, seed=args.seed, device=args.device)
    batch = make_batch(cfg, SyntheticConfig(global_batch=args.batch,
                                            seq_len=args.prompt_len,
                                            seed=args.seed), 0)
    gen, stats = serve_batch(cfg, params, batch, args.gen)
    print(f"generated shape {gen.shape}; sample row: {gen[0][:8].tolist()}")
    print("stats: " + " ".join(f"{k}={v}" for k, v in stats.items()))


if __name__ == "__main__":
    main()
