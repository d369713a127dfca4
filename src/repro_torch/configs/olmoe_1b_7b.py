"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1024
vocab=50304; 64 experts top-8 on every layer [arXiv:2409.02060].

long_500k SKIPPED: pure full attention (DESIGN.md SS4).
"""
from repro_torch.configs.base import (AttnSpec, LayerSpec, MoESpec, ModelConfig,
                                Segment)

_ATTN = AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128, qk_norm=True,
                 rope_theta=10_000.0)
_MOE = MoESpec(n_experts=64, top_k=8, d_ff_expert=1024)


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        d_model=2048,
        vocab_size=50_304,
        segments=(
            Segment(count=16,
                    layers=(LayerSpec(kind="attn", mlp="moe", attn=_ATTN,
                                      moe=_MOE),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=False,
        moe_seq_chunk=1024,
    )
