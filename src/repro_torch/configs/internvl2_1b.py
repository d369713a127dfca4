"""internvl2-1b [vlm] — InternViT frontend STUB + Qwen2-0.5B LM backbone:
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821].

input_specs provides precomputed InternViT patch embeddings
(B, n_patches=256, vit_dim=1024); an MLP projector maps them into the LM
embedding space. Loss on text positions only.
long_500k SKIPPED: pure full attention.
"""
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment

_ATTN = AttnSpec(n_heads=14, n_kv_heads=2, head_dim=64,
                 rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        d_model=896,
        # true vocab 151,655 — padded to a 256-multiple so the vocab dim
        # shards over model=16 (unpadded, the (B,S,V) fp32 logits stay
        # replicated on the TP axis: 39 GB/device at train_4k). Standard
        # embedding padding; extra ids are never produced by data/sampling.
        vocab_size=151_808,
        segments=(
            Segment(count=24,
                    layers=(LayerSpec(kind="attn", mlp="dense", attn=_ATTN,
                                      d_ff=4864),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        vit_dim=1024,
        n_patches=256,
        sub_quadratic=False,
    )
