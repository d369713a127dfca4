"""Model/shape configuration system (a copy of ``repro/configs/base.py``).

A ModelConfig is a declarative description of a transformer-family
architecture as a sequence of *segments*: ``(count, LayerSpec)``. Segments
with count > 1 keep their parameters stacked on a leading ``(count,)`` axis,
as in the reference (which scans over them); the port loops over that axis.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence

LayerKind = Literal["attn", "mla", "mamba", "mlstm", "slstm"]
MlpKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (None = global)
    use_rope: bool = True
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN rope scaling (arXiv:2309.00071) as DeepSeek-V2's ``rope_scaling``
    states it: the rotary frequencies of the pairs past the correction range
    divided by ``factor``, those before it kept, a linear ramp between
    (``beta_fast`` / ``beta_slow`` rotations over ``original_max_position``
    positions bound the range); cos and sin scaled by mscale(``mscale``) /
    mscale(``mscale_all_dim``), and the softmax scale by
    mscale(``mscale_all_dim``)^2, mscale(m) = 0.1 m ln(factor) + 1."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLASpec:
    n_heads: int
    q_lora_rank: Optional[int]            # None: q = x W_q, no q norm
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 10_000.0
    # port-only, a field of ``YarnMLASpec`` (a class attribute here, so the
    # reference's fields stay the spec's fields)
    rope_scaling = None


@dataclasses.dataclass(frozen=True)
class YarnMLASpec(MLASpec):
    """MLA with YaRN rope scaling (DeepSeek-V2-Lite; port-only)."""
    rope_scaling: Optional[YarnScaling] = None


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # port-only, fields of ``DroplessMoESpec`` (class attributes here, so
    # the reference's fields stay the spec's fields): the chosen gates
    # normalized to sum 1 (else scaled by ``routed_scaling_factor``), and
    # the capacity routing of a full sequence
    norm_topk_prob = True
    routed_scaling_factor = 1.0
    dropless = False


@dataclasses.dataclass(frozen=True)
class DroplessMoESpec(MoESpec):
    """MoE whose full-sequence path drops no token: the choices sorted by
    expert and one GEMM per expert (DeepSeek-V2-Lite; port-only). Decode
    keeps the capacity path, whose capacity of every token never drops."""
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    dropless: bool = True


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    n_heads: int = 4
    proj_factor: float = 2.0   # mLSTM up-projection
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind
    mlp: MlpKind = "dense"
    attn: Optional[AttnSpec] = None
    mla: Optional[MLASpec] = None
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm: Optional[XLSTMSpec] = None
    d_ff: int = 0              # dense MLP width (0 = no dense MLP params)


@dataclasses.dataclass(frozen=True)
class Segment:
    """``count`` repetitions of a (possibly heterogeneous) block of layers.

    count > 1 segments keep stacked block params — e.g. Jamba is
    9 x (7 mamba + 1 attention), Gemma-3 is 4 x (5 local + 1 global) + a
    remainder block.
    """
    count: int
    layers: tuple[LayerSpec, ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    vocab_size: int
    segments: tuple[Segment, ...]
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu (gated) | gelu (plain)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # enc-dec (whisper): encoder segments run bidirectional over frontend embeds
    encoder_segments: tuple[Segment, ...] = ()
    encoder_max_len: int = 0
    # vlm: frontend patch-embedding dim (stub provides them precomputed)
    vit_dim: int = 0
    n_patches: int = 256
    # runtime knobs
    remat: bool = True
    scan_segments: bool = True
    moe_seq_chunk: int = 0               # chunk tokens through MoE (0 = off)
    ce_chunk: int = 0                    # seq-chunked CE loss (0 = off):
                                         # never materializes (B,S,V) logits
    sub_quadratic: bool = False          # arch supports long_500k decode
    mla_absorb: bool = False             # absorbed MLA decode (perf variant)
    logits_fp32: bool = True

    @property
    def n_layers(self) -> int:
        return sum(s.count * len(s.layers) for s in self.segments)

    def layer_list(self) -> list[LayerSpec]:
        out: list[LayerSpec] = []
        for s in self.segments:
            out.extend(list(s.layers) * s.count)
        return out


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md SS4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture "
                       "(long_500k needs sub-quadratic attention)")
    return True, ""


# Smoke-test reduction: same family/topology, tiny widths.
def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    def shrink_layer(l: LayerSpec) -> LayerSpec:
        attn = dataclasses.replace(l.attn, n_heads=max(2, min(l.attn.n_heads, 2)),
                                   n_kv_heads=max(1, min(l.attn.n_kv_heads, 2)),
                                   head_dim=16,
                                   window=(min(l.attn.window, 8)
                                           if l.attn.window else None)) \
            if l.attn else None
        mla = dataclasses.replace(l.mla, n_heads=2,
                                  q_lora_rank=16 if l.mla.q_lora_rank else None,
                                  kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                                  v_head_dim=8) if l.mla else None
        moe = dataclasses.replace(l.moe, n_experts=4,
                                  top_k=min(l.moe.top_k, 2), d_ff_expert=32,
                                  n_shared=min(l.moe.n_shared, 1)) if l.moe else None
        mamba = dataclasses.replace(l.mamba, d_state=4) if l.mamba else None
        xl = dataclasses.replace(l.xlstm, n_heads=2) if l.xlstm else None
        return dataclasses.replace(l, attn=attn, mla=mla, moe=moe, mamba=mamba,
                                   xlstm=xl, d_ff=64 if l.d_ff else 0)

    def shrink_segments(segs: Sequence[Segment]) -> tuple[Segment, ...]:
        return tuple(Segment(count=min(s.count, 2),
                             layers=tuple(shrink_layer(l) for l in s.layers))
                     for s in segs)

    return dataclasses.replace(
        cfg,
        d_model=32,
        vocab_size=256,
        segments=shrink_segments(cfg.segments),
        encoder_segments=shrink_segments(cfg.encoder_segments),
        encoder_max_len=8 if cfg.encoder_segments else 0,
        vit_dim=48 if cfg.vit_dim else 0,
        n_patches=8 if cfg.vit_dim else 0,
        dtype="float32",
        moe_seq_chunk=0,
    )
