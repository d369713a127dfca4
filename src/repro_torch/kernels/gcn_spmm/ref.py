"""Plain PyTorch versions of the GCN aggregation kernels (port of
``repro/kernels/gcn_spmm/ref.py``). The CPU path runs these; on the card
they serve only to check the kernel."""
import torch


def spmm_ref(adj: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    return (adj.float() @ feats.float()).to(feats.dtype)


def scaled_spmm_ref(adj: torch.Tensor, feats: torch.Tensor,
                    row_scale: torch.Tensor,
                    col_scale: torch.Tensor) -> torch.Tensor:
    """(diag(r) @ adj @ diag(c)) @ feats in the kernel's operation order:
    column scale before the matmul, row scale on the fp32 accumulator, then
    the cast to feats' dtype."""
    a = adj.float() * col_scale.float()[None, :]
    acc = a @ feats.float()
    return (acc * row_scale.float()[:, None]).to(feats.dtype)
