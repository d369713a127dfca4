"""mfu.prefill.moe: the prefill's model operations in an MLA + MoE cell
(``counts_mla_moe.prefill_flops``: each token's matmuls with its routed and
shared experts, MLA attention over the visible pairs, the head on the last
position) over the median time to first token of the window's untraced
batches (the benchmark's clock) and the chip's bf16 peak. A run off the card
reads nothing."""
import statistics

from bench import counts_mla_moe as counts


def read(r):
    ttft = r.profiled.get("ttft_s")
    if not ttft or r.traffic["kind"] != "serve_moe" or r.device.type != "cuda":
        return None
    p = r.profiled
    flops = counts.prefill_flops(r.config, p["batch"], p["prompt"])
    return 100.0 * flops / counts.PEAKS["bf16_flops_per_s"] \
        / statistics.median(ttft)
