"""One-token GQA attention against a KV cache: CUDA kernel, plain version, dispatch."""
