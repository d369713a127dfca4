"""mfu.train: the model operations of the traced training steps
(``counts.train_step_flops``: forward and backward, nothing recomputed)
over the traced stretch's time and the chip's bf16 peak."""
from bench import counts


def read(r):
    if r.traced is None or not r.traced.device or r.traffic["kind"] != "train":
        return None
    p = r.profiled
    flops = p["steps"] * counts.train_step_flops(r.config, p["batch"], p["seq_len"])
    return 100.0 * flops / counts.PEAKS["bf16_flops_per_s"] / r.traced.window_s
