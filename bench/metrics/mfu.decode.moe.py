"""mfu.decode.moe: the decode step's share of the chip's peak in an MLA +
MoE cell: per step the least time it needs (``counts_mla_moe.decode_step``:
its operations at the bf16 peak or its bytes at the HBM peak, the larger;
the experts its tokens chose, from the routing record) over the measured
time per step, ``serve_batch``'s ``decode_s`` / ``decode_steps``, over the
window's untraced batches. A run off the card
reads nothing."""
from bench import counts_mla_moe as counts


def read(r):
    spans, hits = r.spans.get("serve"), r.profiled.get("decode_hits")
    if not spans or not hits or r.traffic["kind"] != "serve_moe" \
            or r.device.type != "cuda":
        return None
    c, p = r.config, r.profiled
    need = sum(counts.bound_s(*counts.decode_step(c, p["batch"], p["prompt"] + i + 1,
                                                  step))
               for batch in hits for i, step in enumerate(batch))
    spent = sum(s["decode_s"] for s in spans)
    return 100.0 * need / spent if spent else None
