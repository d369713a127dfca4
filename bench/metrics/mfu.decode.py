"""mfu.decode: the replayed decode step's share of the chip's peak: the
least time each step needs (``counts.decode_step``: its operations at the
bf16 peak or its bytes at the HBM peak, the larger; every weight read once
and the valid K/V) over the measured time per step. The steps are timed
between the starts of their first layer's decode kernel, from the first
replay to the last, in the traced batch."""
from bench import counts

KERNELS = ("decode_kernel",)


def read(r):
    if r.traced is None or r.traffic["kind"] != "serve_batch":
        return None
    ks = sorted(r.traced.kernels(*KERNELS), key=lambda a: a.start)
    c, p = r.config, r.profiled
    n_layers, g = c["num_hidden_layers"], p["gen"]
    if len(ks) == n_layers * g:          # the warm-up step, then the replays
        starts = [ks[j * n_layers].start for j in range(1, g)]
    elif len(ks) == n_layers * (g - 1):
        starts = [ks[j * n_layers].start for j in range(g - 1)]
    else:
        return None
    if len(starts) < 2:
        return None
    need = sum(counts.bound_s(*counts.decode_step(
        c, p["batch"], counts.visible(p["prompt"] + i, c["sliding_window"])))
        for i in range(len(starts) - 1))
    return 100.0 * need / (starts[-1] - starts[0])
