"""The flash forward launches a model's attention layers send to the
``wgmma`` body, for the card tests that count launches by wrapper name.
Imports no JAX."""
import torch

from repro_torch.kernels.flash_attention import kernel as tflash


def wgmma_share(cfg, n: int) -> int:
    """Of ``n`` forward launches of ``cfg``'s causal attention layers,
    those the dispatch rule sends to the wgmma body (all or none: one head
    geometry a model)."""
    attn = [l.attn for seg in cfg.segments for l in seg.layers
            if l.kind == "attn" and l.attn.causal]
    if not attn:
        return 0
    a = attn[0]
    plan = tflash.dispatch(a.head_dim, getattr(torch, cfg.dtype), [],
                           group=a.n_heads // a.n_kv_heads)
    return n if plan["body"] == "wgmma" else 0
