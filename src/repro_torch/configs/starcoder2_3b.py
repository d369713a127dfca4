"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA, RoPE, LayerNorm + plain-GeLU MLP [arXiv:2402.19173].

long_500k SKIPPED: pure full attention (DESIGN.md SS4).
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_ATTN = AttnSpec(n_heads=24, n_kv_heads=2, head_dim=128,
                 rope_theta=100_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        d_model=3072,
        vocab_size=49_152,
        segments=(
            Segment(count=30,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_ATTN,
                                      d_ff=12_288),)),
        ),
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
        sub_quadratic=False,
    )
