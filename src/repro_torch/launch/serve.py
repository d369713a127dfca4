"""Serving launcher — batched prefill + greedy decode over the registry API.
Port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Every family of ``configs.ARCHS`` serves: ``--arch whisper-small`` feeds
random frame embeddings (1,500 frames at full width) to the encoder,
``--arch internvl2-1b`` random patch embeddings (256) ahead of the prompt.

Runs on the CUDA device unless ``--device`` says otherwise. On the card the
decode loop replays one captured CUDA graph of the decode step
(``DecodeGraph``), the counterpart of the reference's jitted step with
donated caches; on the CPU, the caller's explicit choice, it runs eagerly.
The prefill stays eager: it runs once per call at a shape of its own, so a
capture would cost more than it saves.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import _device
from repro_torch._tree import tree_map
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.models import common as cc
from repro_torch.models.registry import get_api
from repro_torch.obs.device import count, span
from repro_torch.training.train_step import (device_batch, make_decode_step,
                                             make_prefill)


def _clock(device: torch.device) -> float:
    """Host clock after the device has finished the work queued so far (the
    reference's ``block_until_ready``): without it a CUDA run would time
    only the launches. ``perf_counter``: a clock that nothing steps."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _warmup_caches(caches):
    """The caches for ``DecodeGraph``'s eager warm-up step: a copy of every
    cache the step writes. The encoder-decoder's cross K/V are read-only
    and shared, not copied (221 MB at whisper-small's full width, B 4)."""
    if isinstance(caches, dict) and "cross" in caches:
        return {"self": tree_map(torch.clone, caches["self"]),
                "cross": caches["cross"]}
    return tree_map(torch.clone, caches)


class DecodeGraph:
    """``decode_fn`` (``make_decode_step``'s ``serve_step``) captured once as
    a CUDA graph and replayed once per generated token.

    The step's inputs live in static device buffers: the token, ``pos`` as a
    0-d int32 tensor and the caches, which the step updates in place (the
    reference donates them): attention's K/V (and a ring's slot
    positions), MLA's ``{"ckv", "k_rope"}``, Mamba's ``{"h", "conv"}``,
    mLSTM's ``{"c", "n", "m", "conv"}``, sLSTM's ``{"c", "n", "h", "m"}``
    and the encoder-decoder's ``{"self": [...], "cross": [...]}``, whose
    cross K/V the step only reads. The graph ends by writing its token into
    column ``i`` of ``tokens``, feeding it back as the next input and
    advancing ``pos`` and ``i``, so a replay needs no host work besides the
    launch. Before the capture one eager step runs on the capture's side
    stream, on a copy of the caches it writes (``_warmup_caches``): a
    recurrent state advances at every step, so a step on the caches
    themselves would be one step too many. The graph holds the memory of
    its intermediates until ``release``.

    Launch counting: the warm-up's kernels count as they run; the capture
    records ``held`` (wrapper -> launches in the graph, from
    ``kernel.CAPTURED``) and every replay adds them to ``LAUNCHES``."""

    def __init__(self, decode_fn, params, token: torch.Tensor, pos: int,
                 caches, steps: int):
        dev = token.device
        self.steps = steps
        self.replays = 0
        self.token = token.clone()
        self.pos = torch.full((), pos, dtype=torch.int32, device=dev)
        self.col = torch.zeros((1,), dtype=torch.long, device=dev)
        self.tokens = torch.zeros((token.shape[0], steps), dtype=torch.int32,
                                  device=dev)
        with span("serve.capture"):
            scratch = _warmup_caches(caches)
            side = _device.side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            before = dict(dec_kernel.CAPTURED)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                with span("serve.capture.warmup"):
                    decode_fn(params, self.token, self.pos, scratch)
                # capture_begin, not torch.cuda.graph(): that one empties the
                # allocator's cache first, and the next prefill would pay to
                # allocate its memory again
                self.graph.capture_begin()
                try:
                    nxt, _ = decode_fn(params, self.token, self.pos, caches)
                    self.tokens.index_copy_(1, self.col, nxt)
                    self.token.copy_(nxt)
                    self.pos.add_(1)
                    self.col.add_(1)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch   # after the wait: its last use was on the side stream
        self.held = {k: dec_kernel.CAPTURED[k] - n for k, n in before.items()}

    def replay(self) -> None:
        """Decode the next token (at most ``steps`` replays)."""
        if self.replays >= self.steps:
            raise RuntimeError(f"DecodeGraph holds columns for {self.steps} "
                               "tokens; capture a new one to decode more")
        self.graph.replay()
        self.replays += 1
        dec_kernel.count_replays(self.held)

    def release(self) -> None:
        """Free the graph and its memory pool."""
        self.graph.reset()


@torch.no_grad()
def serve_batch(cfg, params, batch: dict, gen_tokens: int, log=print):
    """Prefill the prompt batch, then greedy-decode gen_tokens. Returns
    (generated (B, gen) int32 numpy, stats dict).

    Runs where ``params`` lie. On a CUDA device it turns on
    ``RUNTIME["use_flash"]`` (the hand-written attention kernels), as the
    reference does on its accelerator, and decodes by replaying one captured
    graph of the step (``DecodeGraph``); on the CPU the steps run eagerly.
    Each decode step writes the new token into the prefill-time caches in
    place (the reference donates them). ``stats`` has the reference's keys,
    ``backend`` being the device type, plus ``decode_capture_s``: the
    warm-up step and the capture, timed between the prefill and the decode
    clocks (0 on the CPU).

    ``batch`` holds ``tokens`` and the family's ``frames`` (audio) or
    ``patches`` (vlm), which go to the device in the config's activation
    dtype (``device_batch``). A VLM's patches take the first ``n_patches``
    positions, so the cache holds ``n_patches + S + gen_tokens`` and the
    first decode step sits at ``n_patches + S``, as in the reference.

    With a recorder installed (``obs.recording``) the call is the span
    ``serve.batch``, holding ``serve.prefill`` (the call to the first token
    on the device), ``serve.capture`` (``DecodeGraph``), ``serve.decode``
    (the steps, to the device's end), ``serve.release`` and ``serve.fetch``,
    and it adds its decode steps to the counter ``serve.decode.steps``
    (``obs/device.py``)."""
    with span("serve.batch"):
        return _serve_batch(cfg, params, batch, gen_tokens, log)


def _serve_batch(cfg, params, batch: dict, gen_tokens: int, log):
    device = _device.of(params)
    if device.type == "cuda":
        cc.RUNTIME["use_flash"] = True
    api = get_api(cfg)
    prefill_fn = make_prefill(cfg, api)
    decode_fn = make_decode_step(cfg, api)
    inputs = device_batch(cfg, {k: v for k, v in batch.items()
                                if k in ("tokens", "frames", "patches")},
                          device)
    b, s = inputs["tokens"].shape
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    max_len = extra + s + gen_tokens

    t0 = _clock(device)
    with span("serve.prefill"):
        last_logits, caches = prefill_fn(params, inputs, max_len)
        token = torch.argmax(last_logits[:, -1], dim=-1).to(torch.int32)[:, None]
        t_prefill = _clock(device) - t0

    decode_steps = gen_tokens - 1
    t_capture = 0.0
    if device.type == "cuda" and decode_steps > 0:
        t0 = _clock(device)
        graph = DecodeGraph(decode_fn, params, token, extra + s, caches,
                            decode_steps)
        t_capture = _clock(device) - t0
        t0 = _clock(device)
        with span("serve.decode"):
            for _ in range(decode_steps):
                graph.replay()
            t_decode = _clock(device) - t0
        gen = torch.cat([token, graph.tokens], dim=1)
        with span("serve.release"):
            graph.release()
    else:
        out = [token]
        t0 = _clock(device)
        with span("serve.decode"):
            for i in range(decode_steps):
                token, caches = decode_fn(params, token, extra + s + i, caches)
                out.append(token)
            t_decode = _clock(device) - t0
        gen = torch.cat(out, dim=1)
    count("serve.decode.steps", decode_steps)
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
        "decode_capture_s": t_capture,
    }
    log(f"prefill {s} toks x{b}: {t_prefill:.2f}s; "
        f"capture {t_capture:.2f}s; decode {decode_steps} steps: {t_decode:.2f}s "
        f"({stats['tokens_per_s']:.1f} tok/s)")
    with span("serve.fetch"):
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
