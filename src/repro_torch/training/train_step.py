"""Serving-step builders. Port of the serving half of
``repro/training/train_step.py``; the train-step builders (loss, grads,
AdamW) wait for the training slice.

The builders return plain functions over (params, batch / token, caches);
PyTorch runs them eagerly, so nothing is traced or compiled.
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
    """(params, token (B,1), pos int, caches) -> (next_token (B,1) int32,
    caches). Greedy: the argmax of the last logits. The caches are updated
    in place."""
    api = api or get_api(cfg)

    def serve_step(params, token, pos: int, caches):
        logits, caches = api.decode_step(params, cfg, token, pos, caches)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], caches

    return serve_step


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """Decode caches for serve_step (the lm family)."""
    from repro_torch.models import decoder_lm as dlm
    return dlm.init_caches(cfg, batch, max_len, device=device)
