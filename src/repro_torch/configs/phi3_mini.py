"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192
vocab=32064; RoPE + SwiGLU [arXiv:2404.14219].

long_500k SKIPPED: pure full attention (DESIGN.md SS4).
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_ATTN = AttnSpec(n_heads=32, n_kv_heads=32, head_dim=96,
                 rope_theta=10_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        d_model=3072,
        vocab_size=32_064,
        segments=(
            Segment(count=32,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_ATTN,
                                      d_ff=8192),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=False,
    )
