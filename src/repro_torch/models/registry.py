"""Model registry: family -> (init / loss / prefill / decode) entry points.
Port of ``repro/models/registry.py``.

Families:
  * ``lm``    — decoder-only LM (dense, MoE, hybrid, SSM: anything built
                from ``decoder_lm`` segments);
  * ``audio`` — encoder-decoder (whisper): frontend-stub frames in, text
                out (``encdec``);
  * ``vlm``   — ViT-stub patches + text tokens into a decoder LM (``vlm``).

Every entry point takes ``(params, cfg, ...)``; the batch dicts are those
of ``data.synthetic.make_batch`` as tensors on the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder_lm as dlm
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import vlm as vlm_mod


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable[..., Any]
    loss_and_metrics: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Any] | None = None


def _lm_api() -> ModelApi:
    return ModelApi(
        init_params=dlm.init_params,
        loss_and_metrics=dlm.loss_and_metrics,
        prefill=dlm.prefill,
        decode_step=dlm.decode_step,
        init_caches=dlm.init_caches,
    )


def _encdec_api() -> ModelApi:
    return ModelApi(
        init_params=encdec_mod.init_params,
        loss_and_metrics=encdec_mod.loss_and_metrics,
        prefill=encdec_mod.prefill,
        decode_step=encdec_mod.decode_step,
    )


def _vlm_api() -> ModelApi:
    return ModelApi(
        init_params=vlm_mod.init_params,
        loss_and_metrics=vlm_mod.loss_and_metrics,
        prefill=vlm_mod.prefill,
        decode_step=vlm_mod.decode_step,
        init_caches=dlm.init_caches,
    )


_RUNNER = {"audio": _encdec_api, "vlm": _vlm_api}


def get_api(cfg: ModelConfig) -> ModelApi:
    return _RUNNER.get(cfg.family, _lm_api)()
