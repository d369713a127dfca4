"""The paper's GNN: edge pooling (Eq. 4) + GCN stack (Eq. 1) + node head.
Port of ``repro/core/gnn.py``.

Functional PyTorch: ``init(cfg, d_in, seed=..., device=...)`` builds a nested
dict of tensors with the reference pytree's keys
(``edge_pool/{w_self,w_neigh,w_edge,bias}``, ``gcn[i]/{w,w_self,bias}``,
``head/{w,bias}``), and ``apply(params, cfg, feats, lat_adj)`` returns
per-node logits. ``params_from_numpy`` / ``params_to_numpy`` carry weights
across from the reference (``jax.tree.map(np.asarray, params)``).

Edge pooling folds edge weights into node features so a standard
node-classification GCN can see communication latency:

    v^(1) = sigma( sum_{u in N(v)} f(v^(0), u^(0), e_vu) )           (Eq. 4)

with f linear: f(v, u, e) = W_v v + W_u u + w_e * e + b. The sum over
neighbours factorizes into dense matmuls:

    sum_u f = deg(v) * (v W_v) + A_mask @ (U W_u) + rowsum(A_lat) (x) w_e + deg(v) * b

so the hot spot is the (n x n) @ (n x d) aggregation. With ``use_pallas``
(the reference's name for the switch) it is routed through
``kernels/gcn_spmm``: the degree / Kipf-Welling normalization is fused into
the hand-written CUDA kernel on the card (its plain version on the CPU)
instead of materializing the normalized (n, n) matrix.

The GCN layers use the Kipf-Welling normalized adjacency
D^-1/2 (A + I) D^-1/2 computed from the mask (Eq. 1's 1/c_uv).

``apply`` takes an optional ``node_mask`` so graphs padded into power-of-two
node buckets (core.train's inference path) are provably inert: masked-out
nodes contribute no edges, no degree, and no edge-latency mass to any real
node's output.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch._tree import (leaves, tensor_from_numpy, tensor_to_numpy,
                              tree_map)
from repro_torch.kernels.gcn_spmm import ops as spmm_ops

Params = Any   # nested dict / list of tensors


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    hidden: int = 213           # -> ~188k params with 2 GCN layers (paper Fig. 4)
    n_gcn_layers: int = 2
    n_classes: int = 4
    use_pallas: bool = False    # route aggregation through kernels/gcn_spmm
    edge_scale: float = 1e-3    # latencies are O(100) ms; scale into O(0.1)


def _dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    scale = 1.0 / float(np.sqrt(d_in))
    return torch.empty((d_in, d_out)).uniform_(-scale, scale, generator=gen)


def init(cfg: GNNConfig, d_in: int, seed: int = 0, device=None) -> Params:
    """Fresh params with the reference's distributions (uniform +-1/sqrt(d_in),
    ``w_edge`` normal x 0.1, zero biases). Drawn on the CPU from a seeded
    ``torch.Generator`` (so every device gets the same numbers), then moved.
    ``jax.random`` draws other numbers: compare with the reference by
    injecting its params, never by two inits."""
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "edge_pool": {
            "w_self": _dense_init(gen, d_in, cfg.hidden),
            "w_neigh": _dense_init(gen, d_in, cfg.hidden),
            "w_edge": torch.randn(cfg.hidden, generator=gen) * 0.1,
            "bias": torch.zeros(cfg.hidden),
        },
        "gcn": [],
        "head": {
            "w": _dense_init(gen, cfg.hidden, cfg.n_classes),
            "bias": torch.zeros(cfg.n_classes),
        },
    }
    for _ in range(cfg.n_gcn_layers):
        params["gcn"].append({
            "w": _dense_init(gen, cfg.hidden, cfg.hidden),
            # self/residual path: keeps node identity on dense graphs where
            # pure neighbourhood averaging over-smooths (all-pairs fleets).
            "w_self": _dense_init(gen, cfg.hidden, cfg.hidden),
            "bias": torch.zeros(cfg.hidden),
        })
    return tree_map(lambda t: t.to(dev), params)


def params_from_numpy(tree, device=None) -> Params:
    """Reference params as numpy arrays -> the port's dict of tensors
    (bfloat16 leaves by bit pattern, see ``_tree.tensor_from_numpy``)."""
    dev = _device.resolve(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def params_to_numpy(params: Params):
    return tree_map(tensor_to_numpy, params)


def n_params(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))


def d_in_of(params: Params) -> int:
    """Input feature width a param tree was initialized for. Combined with
    ``graph.version_for_dim`` this makes checkpoints self-describing: the
    loaded weights determine which node-feature schema inference must build
    (the feature-version shim)."""
    return int(params["edge_pool"]["w_self"].shape[0])


def edge_mask(lat_adj: torch.Tensor, node_mask: torch.Tensor | None,
              dtype) -> torch.Tensor:
    """0/1 edge mask; ``node_mask`` (n,) zeroes every edge touching padding."""
    mask = (lat_adj > 0).to(dtype)
    if node_mask is not None:
        mask = mask * node_mask[:, None] * node_mask[None, :]
    return mask


def edge_pool(params: Params, cfg: GNNConfig, feats: torch.Tensor,
              lat_adj: torch.Tensor,
              node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 4: embed edge (latency) information into node features."""
    p = params["edge_pool"]
    mask = edge_mask(lat_adj, node_mask, feats.dtype)
    if node_mask is not None:
        # padding rows carry no features and no latency mass
        feats = feats * node_mask[:, None]
        lat_adj = lat_adj * mask
    deg = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)  # (n, 1)
    # mean-normalized sum over neighbours (keeps scales stable across degrees)
    self_term = feats @ p["w_self"]
    if cfg.use_pallas:
        neigh_term = spmm_ops.scaled_spmm(
            mask, feats @ p["w_neigh"], 1.0 / deg[:, 0],
            torch.ones(mask.shape[1], dtype=feats.dtype, device=feats.device))
    else:
        neigh_term = (mask @ (feats @ p["w_neigh"])) / deg
    edge_rowsum = (lat_adj * cfg.edge_scale).sum(dim=1, keepdim=True) / deg
    edge_term = edge_rowsum * p["w_edge"][None, :]
    return F.relu(self_term + neigh_term + edge_term + p["bias"])


def _with_self_loops(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(A + I, (deg of A + I)^-1/2 with 0 where the degree is 0)."""
    a = mask + torch.eye(mask.shape[0], dtype=mask.dtype, device=mask.device)
    d = a.sum(dim=1)
    inv_sqrt = torch.where(d > 0, 1.0 / torch.sqrt(d), torch.zeros_like(d))
    return a, inv_sqrt


def normalized_adjacency(mask: torch.Tensor) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 (Kipf-Welling)."""
    a, inv_sqrt = _with_self_loops(mask)
    return a * inv_sqrt[:, None] * inv_sqrt[None, :]


def apply(params: Params, cfg: GNNConfig, feats: torch.Tensor,
          lat_adj: torch.Tensor,
          node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Forward pass -> (n, n_classes) logits. Rows where ``node_mask`` is 0
    are padding: they never influence a real node's logits."""
    h = edge_pool(params, cfg, feats, lat_adj, node_mask)
    mask = edge_mask(lat_adj, node_mask, feats.dtype)
    if cfg.use_pallas:
        # fused path: Kipf-Welling scales ride inside the kernel
        a, inv_sqrt = _with_self_loops(mask)
        for layer in params["gcn"]:
            agg = spmm_ops.scaled_spmm(a, h, inv_sqrt, inv_sqrt)
            h = F.relu(agg @ layer["w"] + h @ layer["w_self"] + layer["bias"])
    else:
        a_norm = normalized_adjacency(mask)
        for layer in params["gcn"]:
            h = F.relu((a_norm @ h) @ layer["w"]
                       + h @ layer["w_self"] + layer["bias"])
    return h @ params["head"]["w"] + params["head"]["bias"]


def loss_fn(params: Params, cfg: GNNConfig, feats, lat_adj, labels,
            label_mask, node_mask=None) -> tuple[torch.Tensor, dict]:
    """Masked cross-entropy (Eq. 5 — sparse supervision per paper §3).
    ``label_mask`` must be 0 on padded rows, so padding never enters the
    loss or accuracy denominators."""
    logits = apply(params, cfg, feats, lat_adj, node_mask)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    denom = torch.clamp(label_mask.sum(), min=1.0)
    loss = (nll * label_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * label_mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc}
