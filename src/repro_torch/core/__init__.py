"""Hulk core, ported to PyTorch: the paper's contribution.

Graph representation of a geo-distributed fleet (graph.py), the edge-pooling
GCN (gnn.py) and its trainer (train.py), the oracle labeler (labels.py),
Algorithm 1 task assignment + disaster recovery (assign.py), the
communication/computation cost model (cost_model.py), the paper's comparison
Systems A/B/C (baselines.py), and the pod-level runtime plan (placement.py).
"""
from repro_torch.core.graph import (ClusterGraph, Machine, paper_fig1_graph,
                                    paper_fleet46, random_fleet)
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.assign import (Assignment, PlacementError,
                                     task_assignments, recover)

__all__ = [
    "ClusterGraph", "Machine", "paper_fig1_graph", "paper_fleet46",
    "random_fleet", "GNNConfig", "Assignment", "PlacementError",
    "task_assignments", "recover",
]
