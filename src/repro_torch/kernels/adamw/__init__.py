"""AdamW's step in two multi-tensor passes (global norm, update): CUDA kernel and its rule."""
