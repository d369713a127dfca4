"""Device resolution for the port's entry points: CUDA unless asked otherwise.

There is no fallback: ``device=None`` means the CUDA device, and a machine
without one raises instead of quietly running on the CPU. ``side_stream``
is the one stream per device on which the port's CUDA graphs warm up and
are captured.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the current CUDA device (``RuntimeError`` if there is
    none); anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def of(tree) -> torch.device:
    """Device of the first tensor in a nested dict/list of tensors."""
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


_SIDE_STREAMS: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream per CUDA device, reused: every new
    stream would get its own cuBLAS workspace, which stays allocated."""
    if device.index not in _SIDE_STREAMS:
        _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device.index]
