"""flash_bwd_roofline: the flash backward's share of its roofline in the
traced training steps: the least time the steps' backward calls need
(``counts.flash_bwd``, one call per layer and step) over the device time of
the backward's kernels (the prep, the backward body, the GQA sum)."""
from bench import counts

KERNELS = ("bwd_prep_kernel", "bwd_wgmma_kernel", "dkv_reduce_kernel",
           "delta_kernel", "dq_f32_kernel", "dkv_f32_kernel")


def read(r):
    if r.traced is None or r.traffic["kind"] != "train":
        return None
    ks = r.traced.kernels(*KERNELS)
    if not ks:
        return None
    c, p = r.config, r.profiled
    flops, nbytes = counts.flash_bwd(p["batch"], p["seq_len"],
                                     c["num_attention_heads"],
                                     c["num_key_value_heads"], c["head_dim"],
                                     counts.ELT[c["torch_dtype"]],
                                     c["sliding_window"])
    need = p["steps"] * c["num_hidden_layers"] * counts.bound_s(flops, nbytes)
    return 100.0 * need / sum(k.dur for k in ks)
