"""Causal / sliding-window GQA attention: CUDA kernel, plain version, dispatch."""
