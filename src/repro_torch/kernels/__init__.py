"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""


def check_block(block, name: str) -> None:
    """A block keyword of the reference's ops must be a positive int (the
    reference clamps it to ``min(block, max(8, next_pow2(n)))`` and tiles
    by it). The port's kernels keep their own tiling, so the value is only
    checked."""
    if isinstance(block, bool) or not isinstance(block, int) or block < 1:
        raise ValueError(f"{name} must be a positive int, got {block!r}")
