"""The numbers that decide ``correct``, each worked out from the program's
readings and the reference's.

Serving: the widest gap by which a served token's logit lies below the
reference's best logit at its position (0 where the reference would have
chosen it too), and the mean of those gaps over the served tokens compared.
The control's numbers are the same, for the tokens that the control puts
first. A cell's limits file names the numbers it holds.

Training: the worst relative gap of the step losses, and by the worst leaf
the gap between the program's norm and the reference's, of the first
gradient as AdamW receives it and of the change of the weights after the
checked steps, each over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out.
"""
from __future__ import annotations

import statistics

import torch

TINY_GRAD = 1e-3


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref_logits (R, G, V) fp32, served (R, G) -> each served token's gap
    below the reference's best logit at its position (R, G)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, served[..., None].long())[..., 0]


def serve_numbers(gaps: torch.Tensor) -> dict:
    """Per request (R,): ``gap``, the widest gap of its served tokens, and
    ``mean_gap``, their mean gap."""
    return {"gap": gaps.amax(-1), "mean_gap": gaps.mean(-1)}


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor) -> torch.Tensor:
    """The gap, in the reference, of each token the control puts first."""
    return token_gaps(ref_logits, ctl_logits.argmax(-1))


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}; ``ref`` also "grad_raw"."""
    med = statistics.median(ref["grad_raw"].values())
    keep = [k for k, v in ref["grad_raw"].items() if v >= TINY_GRAD * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    return {"loss": loss,
            "grad": _worst_leaf(prog["grad"], ref["grad"], keep),
            "change": _worst_leaf(prog["change"], ref["change"], keep),
            "left_out": sorted(set(ref["grad_raw"]) - set(keep))}
