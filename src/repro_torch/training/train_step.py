"""Serving-step builders. Port of the serving half of
``repro/training/train_step.py``; the train-step builders (loss, grads,
AdamW) wait for the training slice.

``make_prefill`` and ``make_decode_step`` return plain functions over
(params, batch / token, caches). PyTorch runs them eagerly;
``launch/serve.py`` captures the decode step in a CUDA graph on the card,
the counterpart of the reference's jitted step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import ModelApi, get_api


def make_prefill(cfg: ModelConfig, api: ModelApi | None = None) -> Callable:
    """(params, batch, max_len) -> (last_logits, caches)."""
    api = api or get_api(cfg)

    def prefill_step(params, batch, max_len: int):
        return api.prefill(params, cfg, tokens=batch["tokens"], max_len=max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, api: ModelApi | None = None) -> Callable:
    """(params, token (B,1), pos, caches) -> (next_token (B,1) int32,
    caches). ``pos`` is an int or a 0-d int32 tensor on the params' device,
    as the reference's ``serve_step`` takes a traced scalar. Greedy: the
    argmax of the last logits. The caches are updated in place."""
    api = api or get_api(cfg)

    def serve_step(params, token, pos, caches):
        logits, caches = api.decode_step(params, cfg, token, pos, caches)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], caches

    return serve_step


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """Decode caches for serve_step (the lm family)."""
    from repro_torch.models import decoder_lm as dlm
    return dlm.init_caches(cfg, batch, max_len, device=device)
