"""flash_fwd_roofline.mla: the flash forward's share of its roofline in the
traced batch's MLA prefill: the least time the prefill's attention calls
need (``counts_mla_moe.flash_fwd_mla`` at the model's widths, q and k at
nope + rope, v and o at v's; one call per layer) over the device time of
the forward kernels."""
from bench import counts_mla_moe as counts

KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(r):
    if r.traced is None or r.traffic["kind"] != "serve_moe":
        return None
    ks = r.traced.kernels(*KERNELS)
    if not ks:
        return None
    c, p = r.config, r.profiled
    need = c["num_hidden_layers"] * counts.bound_s(*counts.flash_fwd_mla(
        c, p["batch"], p["prompt"], counts.ELT[c["torch_dtype"]]))
    return 100.0 * need / sum(k.dur for k in ks)
