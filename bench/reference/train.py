"""The plain reference of the training step: the loss of ``model.hidden``
and ``model.head`` (mean next-token cross-entropy over every position), its
gradient by autograd in float32, and AdamW as the traffic file's
``optimizer`` states it: global-norm clipping, bias-corrected moments in
float32, decoupled weight decay on every matrix and none on norm scales,
the learning rate warmed up linearly and then held or decayed by a cosine.
Each weight is stored in its leaf's dtype, as the configuration states:
after every update a bfloat16 leaf is rounded to bfloat16.

The weights are float32 tensors, one per layer of each leaf (``P[name]``,
a list), so that a reading per leaf is a reading per layer. Rows are
differentiated one at a time and layers recomputed in the backward, so that
the state (weights, gradients and moments, 16 bytes a parameter) and one
row's activations fit on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import model
from bench.weights import leaf_specs

CE_BLOCK = 1024


def _nll_block(x, labels, cfg, W, precision):
    logits = model.head(x, cfg, W, precision)
    return F.cross_entropy(logits, labels, reduction="sum")


def row_loss(tokens, labels, cfg: dict, W, precision: str, n_total: int):
    """This row's share of the step's loss: its summed NLL over ``n_total``
    tokens."""
    x = model.hidden(tokens[None], cfg, W, precision, remat=True)
    nll = sum(checkpoint(_nll_block, x[0, c:c + CE_BLOCK],
                         labels[c:c + CE_BLOCK], cfg, W, precision,
                         use_reentrant=False)
              for c in range(0, tokens.shape[0], CE_BLOCK))
    return nll / n_total


def schedule(opt: dict, step: int) -> float:
    peak, warm, total = (opt["learning_rate"], opt["warmup_steps"],
                         opt["total_steps"])
    if step < warm:
        return peak * (step + 1.0) / warm
    if total > 0:
        frac = min(1.0, max(0.0, (step - warm) / max(1, total - warm)))
        return peak * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5
                       * (1 + math.cos(math.pi * frac)))
    return peak


class Trainer:
    """The reference's training state, drawn with ``draw(spec, layer)``
    (the benchmark's weights, as bfloat16 or float32 per leaf)."""

    def __init__(self, cfg: dict, opt: dict, draw, precision: str = "fp32"):
        self.cfg, self.opt, self.precision = cfg, opt, precision
        self.specs = {s[0]: s for s in leaf_specs(cfg)}
        self.P = {}
        for name, (_, shape, _, _) in self.specs.items():
            n = shape[0] if name.startswith("layers.") else 1
            self.P[name] = [draw(self.specs[name],
                                 i if name.startswith("layers.") else None)
                            .float().requires_grad_(True) for i in range(n)]
        self.m = {k: [torch.zeros_like(t) for t in v] for k, v in self.P.items()}
        self.v = {k: [torch.zeros_like(t) for t in v] for k, v in self.P.items()}
        self.step_count = 0

    def W(self, name, layer):
        return self.P[name][0 if layer is None else layer]

    def leaves(self):
        """(leaf key, tensor) for every layer of every leaf."""
        for name, ts in self.P.items():
            for i, t in enumerate(ts):
                yield (name if len(ts) == 1 else f"{name}[{i}]"), t

    def loss_and_grads(self, tokens, labels) -> float:
        """The step's loss; the gradient left in each leaf's ``grad``."""
        for _, t in self.leaves():
            t.grad = None
        b = tokens.shape[0]
        n_total = tokens.numel()
        loss = 0.0
        for r in range(b):
            nll = row_loss(tokens[r], labels[r], self.cfg, self.W,
                           self.precision, n_total)
            nll.backward()
            loss += float(nll.detach())
        return loss

    @torch.no_grad()
    def update(self) -> dict:
        """AdamW on the gradients in ``grad``. Returns the per-leaf norms of
        the gradient as the moments receive it (clipped) and before."""
        opt = self.opt
        raw = {k: float(torch.linalg.vector_norm(t.grad)) for k, t in self.leaves()}
        gnorm = math.sqrt(sum(v * v for v in raw.values()))
        scale = min(1.0, opt["grad_clip_norm"] / (gnorm + 1e-9)) \
            if opt["grad_clip_norm"] > 0 else 1.0
        lr = schedule(opt, self.step_count)
        t = self.step_count + 1
        c1, c2 = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
        for name, ts in self.P.items():
            dtype = self.specs[name][2]
            decay = not name.endswith(".scale")
            for i, p in enumerate(ts):
                g = p.grad * scale
                m, v = self.m[name][i], self.v[name][i]
                m.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                u = (m / c1) / (torch.sqrt(v / c2) + opt["eps"])
                if opt["weight_decay"] > 0 and decay:
                    u = u + opt["weight_decay"] * p
                new = p - lr * u
                if dtype == "bfloat16":
                    new = new.to(torch.bfloat16).float()
                p.copy_(new)
                p.grad = None
        self.step_count += 1
        return {"raw": raw, "clipped": {k: v * scale for k, v in raw.items()},
                "grad_norm": gnorm, "lr": lr}

    @torch.no_grad()
    def change_norms(self, draw) -> dict:
        """||p - p0|| per leaf, p0 drawn anew."""
        out = {}
        for name, ts in self.P.items():
            for i, p in enumerate(ts):
                p0 = draw(self.specs[name],
                          i if name.startswith("layers.") else None).float()
                out[name if len(ts) == 1 else f"{name}[{i}]"] = float(
                    torch.linalg.vector_norm(p - p0))
        return out


def readings(cfg: dict, opt: dict, draw, batches, precision: str = "fp32") -> dict:
    """Train ``len(batches)`` steps from the drawn weights. Returns the
    losses, the first gradient's per-leaf norms (clipped as AdamW takes it,
    and raw) and the per-leaf change of the weights after the last step."""
    with model.fp32_matmuls():
        tr = Trainer(cfg, opt, draw, precision)
        losses, first = [], None
        for tokens, labels in batches:
            losses.append(tr.loss_and_grads(tokens, labels))
            norms = tr.update()
            if first is None:
                first = norms
        change = tr.change_norms(draw)
    return {"loss": losses, "grad": first["clipped"], "grad_raw": first["raw"],
            "change": change}
