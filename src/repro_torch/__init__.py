"""PyTorch + CUDA port of the Hulk planner (``repro`` is the JAX reference).

The layout mirrors the reference path for path: ``repro_torch/core/gnn.py``
is the port of ``repro/core/gnn.py``. The package imports ``torch`` and
numpy only, never ``jax`` and nothing of ``repro``. Entry points that create
tensors run on the CUDA device unless the caller passes ``device="cpu"``.
"""
