"""device_idle.moe: the share of the traced batch of an MLA + MoE cell
(prefill, graph capture and replays) in which no operation ran on the
device."""


def read(r):
    if r.traced is None or not r.traced.device or r.traffic["kind"] != "serve_moe":
        return None
    return 100.0 * (1.0 - r.traced.busy_s / r.traced.window_s)
