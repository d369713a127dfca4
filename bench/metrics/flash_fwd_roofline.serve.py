"""flash_fwd_roofline.serve: the flash forward's share of its roofline in
the traced batch's prefill: the least time the prefill's attention calls
need (``counts.flash_fwd`` at the model's head dim, one call per layer)
over the device time of the forward kernels."""
from bench import counts

KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(r):
    if r.traced is None or r.traffic["kind"] != "serve_batch":
        return None
    ks = r.traced.kernels(*KERNELS)
    if not ks:
        return None
    c, p = r.config, r.profiled
    flops, nbytes = counts.flash_fwd(p["batch"], p["prompt"],
                                     c["num_attention_heads"],
                                     c["num_key_value_heads"], c["head_dim"],
                                     counts.ELT[c["torch_dtype"]],
                                     c["sliding_window"])
    need = c["num_hidden_layers"] * counts.bound_s(flops, nbytes)
    return 100.0 * need / sum(k.dur for k in ks)
