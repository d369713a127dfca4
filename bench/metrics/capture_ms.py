"""capture_ms: the warm-up step and graph capture ``serve_batch`` makes in
every call (its ``decode_capture_s``), averaged over the window's untraced
batches."""


def read(r):
    spans = r.spans.get("serve")
    if not spans:
        return None
    return 1e3 * sum(s["decode_capture_s"] for s in spans) / len(spans)
