"""Model registry: family -> (init / prefill / decode) entry points.
Port of ``repro/models/registry.py``.

The ``lm`` family (decoder-only LMs built from ``decoder_lm`` segments)
trains and serves. ``audio`` (encoder-decoder) and ``vlm`` raise until
their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder_lm as dlm


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


_LATER = {"audio": "the encoder-decoder slice (encdec.py, Whisper)",
          "vlm": "the VLM slice (vlm.py, InternVL2)"}


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family in _LATER:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"it waits for {_LATER[cfg.family]}")
    return _lm_api()
