"""deepseek-v2-lite [moe] — 27L d_model=2048 16H vocab=102400; MLA with no
q compression (q_lora_rank None), kv_lora 512, nope 128 / rope 64 / v 128;
64 routed experts top-6 of width 1408 with 2 shared, gates not normalized;
YaRN rope (factor 40 over 4096 positions, mscale 0.707)
[https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434].

Port-only: the reference lists no such config. Layer 0 keeps a dense MLP
(``first_k_dense_replace`` 1, d_ff 10,944); layers 1-26 are MoE. The MoE
layers drop no token (``DroplessMoESpec``), as the published model does at
inference; decode runs the absorbed MLA order. The published checkpoint
keeps q_pe / k_pe interleaved and permutes them before the half rotation:
with drawn weights that is a fixed permutation of weight columns, so the
port rotates halves and a loader would permute the columns once.
"""
from repro_torch.configs.base import (DroplessMoESpec, LayerSpec, ModelConfig,
                                      Segment, YarnMLASpec, YarnScaling)

_MLA = YarnMLASpec(n_heads=16, q_lora_rank=None, kv_lora_rank=512,
                   qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                   rope_theta=10_000.0,
                   rope_scaling=YarnScaling(factor=40.0,
                                            original_max_position=4096,
                                            beta_fast=32.0, beta_slow=1.0,
                                            mscale=0.707,
                                            mscale_all_dim=0.707))
_MOE = DroplessMoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                       norm_topk_prob=False, routed_scaling_factor=1.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        d_model=2048,
        vocab_size=102_400,
        segments=(
            Segment(count=1,
                    layers=(LayerSpec(kind="mla", mlp="dense", mla=_MLA,
                                      d_ff=10_944),)),
            Segment(count=26,
                    layers=(LayerSpec(kind="mla", mlp="moe", mla=_MLA,
                                      moe=_MOE),)),
        ),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=False,
        sub_quadratic=False,
        mla_absorb=True,
    )
