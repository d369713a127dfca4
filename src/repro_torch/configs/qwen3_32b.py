"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936; qk_norm, GQA [hf:Qwen/Qwen3-8B family scaling].

long_500k SKIPPED: pure full attention (DESIGN.md SS4).
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_ATTN = AttnSpec(n_heads=64, n_kv_heads=8, head_dim=128, qk_norm=True,
                 rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        d_model=5120,
        vocab_size=151_936,
        segments=(
            Segment(count=64,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_ATTN,
                                      d_ff=25_600),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=False,
    )
