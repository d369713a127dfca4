"""decode_attention_roofline: the decode kernel's share of its roofline in
the traced batch: the least time its calls need (``counts.decode``: the
valid K/V slots at each step's position, the query, the mask over the
cache's slots, the output) over the device time of ``decode_kernel``. A
batch's calls are one per layer for the graph's eager warm-up step and for
each replay."""
from bench import counts

KERNELS = ("decode_kernel",)


def steps_valid(p: dict, window, n_calls: int, n_layers: int):
    """The valid slots of each step whose calls the trace holds: the
    graph's warm-up step at the prompt's end, then one replay per decode
    step from that same position on."""
    replays = [counts.visible(p["prompt"] + i, window) for i in range(p["gen"] - 1)]
    if n_calls == n_layers * (len(replays) + 1):
        return [counts.visible(p["prompt"], window)] + replays
    if n_calls == n_layers * len(replays):
        return replays
    return None


def read(r):
    if r.traced is None or r.traffic["kind"] != "serve_batch":
        return None
    ks = r.traced.kernels(*KERNELS)
    c, p = r.config, r.profiled
    n_layers = c["num_hidden_layers"]
    valid = steps_valid(p, c["sliding_window"], len(ks), n_layers)
    if not ks or valid is None:
        return None
    t = counts.cache_slots(c, p["prompt"] + p["gen"])
    need = n_layers * sum(
        counts.bound_s(*counts.decode(p["batch"], t, v, c["num_attention_heads"],
                                      c["num_key_value_heads"], c["head_dim"],
                                      counts.ELT[c["torch_dtype"]]))
        for v in valid)
    return 100.0 * need / sum(k.dur for k in ks)
