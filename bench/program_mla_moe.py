"""The system under test for an MLA + DeepSeekMoE configuration
(DeepSeek-V2): ``repro_torch`` driven as its users drive it, as
``bench/program.py`` drives the dense models.

It builds the program's configuration from a file under ``bench/configs``
(every width as the file gives it), hands the program the benchmark's
weights (``bench/weights_mla_moe.py``) in the program's own tree, and
serves through ``launch.serve.serve_batch`` (``program.serve``, which
clocks the first token) with a ``models.mlp.RoutingRecord`` installed, so
that every MoE call of the prefill, of the decode graph's warm-up step and
of its replays writes its expert choices on the device.
"""
from __future__ import annotations

import numpy as np

from bench import program
from repro_torch._tree import map_with_path
from repro_torch.configs.base import (DroplessMoESpec, LayerSpec, ModelConfig,
                                      Segment, YarnMLASpec, YarnScaling)
from repro_torch.models import mlp
from repro_torch.models.registry import get_api


def program_config(cj: dict) -> ModelConfig:
    """The program's ``ModelConfig``: ``first_k_dense_replace`` MLA layers
    with a dense SwiGLU MLP, then MLA layers with dropless MoE."""
    rs = cj["rope_scaling"]
    if rs is not None and rs["type"] != "yarn":
        raise ValueError(f"rope_scaling {rs['type']!r}: the program runs yarn")
    scaling = None if rs is None else YarnScaling(
        factor=float(rs["factor"]),
        original_max_position=rs["original_max_position_embeddings"],
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    mla = YarnMLASpec(n_heads=cj["num_attention_heads"],
                      q_lora_rank=cj["q_lora_rank"],
                      kv_lora_rank=cj["kv_lora_rank"],
                      qk_nope_dim=cj["qk_nope_head_dim"],
                      qk_rope_dim=cj["qk_rope_head_dim"],
                      v_head_dim=cj["v_head_dim"],
                      rope_theta=float(cj["rope_theta"]), rope_scaling=scaling)
    moe = DroplessMoESpec(n_experts=cj["n_routed_experts"],
                          top_k=cj["num_experts_per_tok"],
                          d_ff_expert=cj["moe_intermediate_size"],
                          n_shared=cj["n_shared_experts"],
                          norm_topk_prob=cj["norm_topk_prob"],
                          routed_scaling_factor=float(cj["routed_scaling_factor"]))
    k = cj["first_k_dense_replace"]
    return ModelConfig(
        name=cj["name"], family="moe", d_model=cj["hidden_size"],
        vocab_size=cj["vocab_size"],
        segments=(Segment(count=k, layers=(LayerSpec(
                      kind="mla", mlp="dense", mla=mla,
                      d_ff=cj["intermediate_size"]),)),
                  Segment(count=cj["num_hidden_layers"] - k, layers=(LayerSpec(
                      kind="mla", mlp="moe", mla=mla, moe=moe),))),
        norm="rmsnorm", act="silu", tie_embeddings=cj["tie_word_embeddings"],
        dtype=cj["torch_dtype"], sub_quadratic=False, mla_absorb=True)


def _paths(cfg: ModelConfig, name: str, t):
    """A benchmark leaf -> [(path in the program's tree, tensor view)]."""
    parts = name.split(".")
    if parts[0] != "layers":
        return [(tuple(parts), t)]
    k = cfg.segments[0].count
    kind, rest = parts[1], tuple(parts[2:])
    key = {"attn": ("mla",), "mlp": ("mlp",), "moe": ("moe",)}.get(kind, (kind,))
    if kind == "mlp":
        spans = [(0, t)]
    elif kind == "moe":
        spans = [(1, t)]
    else:
        spans = [(0, t[:k]), (1, t[k:])]
    return [(("segments", seg, 0, *key, *rest),
             s[0] if cfg.segments[seg].count == 1 else s) for seg, s in spans]


def params(cfg: ModelConfig, weights: dict, device) -> dict:
    """The program's params tree holding the benchmark's tensors (views, no
    copy). Every leaf of the program's own tree must be given, in its shape
    and dtype."""
    meta = get_api(cfg).init_params(cfg, seed=0, device="meta")
    given = {}
    for name, t in weights.items():
        given.update(_paths(cfg, name, t))

    def fill(path, leaf):
        t = given.pop(tuple(path), None)
        if t is None or tuple(t.shape) != tuple(leaf.shape) \
                or t.dtype != leaf.dtype:
            raise ValueError(f"program leaf {path} {tuple(leaf.shape)} "
                             f"{leaf.dtype}: the benchmark gives "
                             f"{None if t is None else (tuple(t.shape), t.dtype)}")
        return t.to(device)

    tree = map_with_path(fill, meta)
    if given:
        raise ValueError(f"leaves the program does not have: {sorted(given)}")
    return tree


def routing_record(cfg: ModelConfig, batch: int, max_len: int, device):
    """A record of every MoE layer's choices for a batch."""
    moe = [l.moe for l in cfg.layer_list() if l.mlp == "moe"]
    return mlp.RoutingRecord(len(moe), batch, max_len, moe[0].top_k,
                             moe[0].n_experts, device)


def serve(cfg: ModelConfig, params, prompts: np.ndarray, gen_tokens: int,
          record):
    """``program.serve`` with ``record`` filled by every MoE call. Returns
    (served, stats, ttft, the record's choices on the host (n_moe, B,
    max_len, k) numpy, copied after the batch)."""
    with mlp.record_routing_on_device(record):
        served, stats, ttft = program.serve(cfg, params, prompts, gen_tokens)
    return served, stats, ttft, record.experts.to("cpu", copy=True).numpy()
