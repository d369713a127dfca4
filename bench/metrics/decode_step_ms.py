"""decode_step_ms: the time of one decode step, from ``serve_batch``'s own
spans: all of its ``decode_s`` over all of its ``decode_steps``, over the
window's untraced batches."""


def read(r):
    spans = r.spans.get("serve")
    if not spans or not sum(s["decode_steps"] for s in spans):
        return None
    return 1e3 * sum(s["decode_s"] for s in spans) / sum(s["decode_steps"] for s in spans)
