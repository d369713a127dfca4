"""GCN aggregation ``diag(r) A diag(c) H``: CUDA kernel, plain version, dispatch."""
