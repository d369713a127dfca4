"""The port's cost tools against the reference's: ``analysis.hlo_cost`` and
``analysis.roofline`` on the same HLO text and the same ``HW`` values,
``active_params`` on every config, and the port's own pricer
(``analysis.program_cost``) on meta tensors, through the kernels' dispatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.analysis import hlo_cost as jhlo
from repro.analysis import roofline as jroof
from repro.configs import ARCHS, get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models.registry import get_api as jget_api
from repro.training.train_step import make_prefill as jmake_prefill
from repro_torch import analysis as tanalysis
from repro_torch._tree import leaves as tleaves
from repro_torch.analysis import hlo_cost as thlo
from repro_torch.analysis import program_cost
from repro_torch.analysis import roofline as troof
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.gcn_spmm import kernel as tgcn_kernel
from repro_torch.kernels.gcn_spmm import ops as tgcn


def _text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _scanned(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, None, length=7)
    return y


def _nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None
        c2, _ = jax.lax.scan(inner, c, None, length=3)
        return c2, None
    y, _ = jax.lax.scan(outer, x, None, length=5)
    return y


def _smoke_prefill_text():
    """A lowered prefill of the reduced gemma3-1b, as the reference's
    ``serve_model_from_config`` lowers it."""
    cfg = dataclasses.replace(jreduce(jget_config("gemma3-1b")), remat=False)
    api = jget_api(cfg)
    params = jax.eval_shape(lambda k: api.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 16), jnp.int32)}
    fn = jax.jit(jmake_prefill(cfg, api), static_argnums=(2,))
    return fn.lower(params, batch, 24).compile().as_text()


def _sds(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


HLO_PROGRAMS = {
    "scan": lambda: _text(_scanned, _sds((256, 256)), _sds((256, 256))),
    "nested_scan": lambda: _text(_nested, _sds((128, 128)), _sds((128, 128))),
    "tanh_dot": lambda: _text(lambda x, w: jnp.tanh(x @ w), _sds((64, 64)),
                              _sds((64, 64))),
    "smoke_prefill": _smoke_prefill_text,
}


@pytest.mark.parametrize("program", sorted(HLO_PROGRAMS))
def test_hlo_cost_equals_the_reference_on_the_same_text(program):
    text = HLO_PROGRAMS[program]()
    for kw in ({}, {"tpu_native": True},
               {"exclude_pred": lambda dtype, dims: len(dims) == 4}):
        assert thlo.analyze(text, **kw) == jhlo.analyze(text, **kw)
    assert troof.collective_bytes(text) == jroof.collective_bytes(text)


def test_hlo_cost_shape_bytes_and_trip_counts():
    """The reference's own checks (tests/test_hlo_cost.py) on the copy."""
    assert thlo._shape_bytes("bf16[16,4096,128]{2,1,0}") == 16 * 4096 * 128 * 2
    assert thlo._shape_bytes("(f32[8]{0}, s32[])") == 36
    assert thlo._shape_bytes("pred[]") == 1
    res = thlo.analyze(HLO_PROGRAMS["scan"]())
    assert res["flops"] == 7 * 2 * 256 ** 3 and res["unknown_trip_loops"] == 0
    assert thlo.analyze(HLO_PROGRAMS["nested_scan"]())["flops"] \
        == 15 * 2 * 128 ** 3


def test_collective_bytes_counts_start_ops_once():
    text = "\n".join([
        "%ag = bf16[16,4096]{1,0} all-gather-start(%p), dimensions={0}",
        "%agd = bf16[16,4096]{1,0} all-gather-done(%ag)",
        "%ar = f32[8]{0} all-reduce(%x), to_apply=%add",
        "%cp = (s32[4]{0}, s32[4]{0}) collective-permute(%y)",
    ])
    assert troof.collective_bytes(text) == jroof.collective_bytes(text)
    assert troof.collective_bytes(text)["total"] == 16 * 4096 * 2 + 32 + 32


def _hw_pair():
    ref = jroof.HW()
    return ref, troof.HW(**dataclasses.asdict(ref))


@pytest.mark.parametrize("model_flops_total", [None, 3.2e15])
def test_roofline_report_equals_the_reference_at_its_hw(model_flops_total):
    jhw, thw = _hw_pair()
    for cost, coll in (
            ({"flops": 4.1e14, "bytes": 2.2e11},
             {"total": 3e9, "bf16_native_total": 1.5e9}),
            ({"flops": 1e9, "bytes accessed": 8e12}, {"total": 0.0}),
            ({"flops": 0.0, "bytes": 1.0}, {"total": 5e12})):
        assert troof.roofline_report(cost, coll, 256, model_flops_total, thw) \
            == jroof.roofline_report(cost, coll, 256, model_flops_total, jhw)
    for kind in ("train", "decode"):
        assert troof.model_flops(1.3e9, 4096, kind) \
            == jroof.model_flops(1.3e9, 4096, kind)


def test_hw_defaults_to_the_h100_and_the_exports_match():
    """The port's default is the card's own (H100 SXM data sheet: 989 TFLOP/s
    dense bf16, 3.35 TB/s HBM3, 80 GB; NVLink 4's 900 GB/s both ways is
    450 GB/s each way), never the reference's TPU figures."""
    assert dataclasses.asdict(troof.HW()) == {
        "peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9,
        "hbm_gb": 80.0}
    assert [f.name for f in dataclasses.fields(troof.HW)] \
        == [f.name for f in dataclasses.fields(jroof.HW)]
    import repro.analysis as janalysis
    assert tanalysis.__all__ == janalysis.__all__


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_equals_the_reference(arch):
    assert troof.active_params(tget_config(arch)) \
        == jroof.active_params(jget_config(arch))


# -- the port's pricer ---------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_program_cost_has_hlo_cost_keys_and_prices_a_matmul():
    cost, out = program_cost.measure(lambda a, b: torch.tanh(a @ b),
                                     _meta(64, 32), _meta(32, 16))
    ref = jhlo.analyze(HLO_PROGRAMS["tanh_dot"]())
    assert set(cost) == set(ref)
    assert set(cost["collectives"]) == set(ref["collectives"])
    assert set(cost["collectives"]["per_kind"]) \
        == set(ref["collectives"]["per_kind"])
    assert cost["flops"] == 2 * 64 * 32 * 16
    # mm: both operands in, the product out; tanh: the product in and out
    assert cost["bytes_by_kind"] == {"dot": 4.0 * (64 * 32 + 32 * 16 + 64 * 16),
                                     "tanh": 4.0 * 2 * 64 * 16}
    assert cost["unknown_trip_loops"] == 0
    assert out.shape == (64, 16) and out.device.type == "meta"


def test_program_cost_views_are_free_and_slot_writes_count_the_slot():
    cache = _meta(2, 100, 4, 8)
    new = _meta(2, 1, 4, 8)
    slot = torch.empty((1,), dtype=torch.long, device="meta")

    def write(cache, new, slot):
        cache.index_copy_(1, slot, new)
        return cache[:, :10].transpose(1, 2)

    cost = program_cost.analyze(write, cache, new, slot)
    assert cost["bytes_by_kind"] == {"index_copy_": 2.0 * (2 * 4 * 8 * 4 + 8)}
    assert cost["flops"] == 0


def test_program_cost_refuses_tensors_off_the_meta_device():
    with pytest.raises(ValueError, match="meta tensors only"):
        program_cost.analyze(torch.mm, torch.ones(2, 2), _meta(2, 2))


def test_kernel_dispatch_on_meta_takes_the_plain_function_without_a_launch():
    """A shape-only run prices the attention and aggregation work through
    the plain functions: the right shape and dtype, no launch, and the
    plain function's flops."""
    before = (dict(tflash_kernel.LAUNCHES), dict(tdec_kernel.LAUNCHES),
              dict(tgcn_kernel.LAUNCHES))
    q = _meta(2, 16, 4, 32, dtype=torch.bfloat16)
    k = _meta(2, 16, 2, 32, dtype=torch.bfloat16)
    cost, o = program_cost.measure(tflash.flash_attention, q, k, k)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    assert cost["flops"] == 2 * 2 * (2 * 4 * 16 * 16 * 32)
    qd = _meta(2, 1, 4, 32, dtype=torch.bfloat16)
    od = tdec.decode_attention(qd, k, k, torch.ones(16, dtype=torch.bool,
                                                    device="meta"))
    assert od.shape == qd.shape and od.dtype == qd.dtype and od.is_meta
    a, h = _meta(46, 46), _meta(46, 213)
    r = torch.ones(46, device="meta")
    for out in (tgcn.spmm(a, h), tgcn.scaled_spmm(a, h, r, r)):
        assert out.shape == (46, 213) and out.dtype == h.dtype and out.is_meta
    assert (tflash_kernel.LAUNCHES, tdec_kernel.LAUNCHES,
            tgcn_kernel.LAUNCHES) == before


def test_meta_init_draws_nothing_and_gives_the_cpu_tree():
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models import decoder_lm as tdlm
    from repro_torch._tree import map_with_path
    cfg = reduce_for_smoke(tget_config("jamba-1.5-large-398b"))
    cpu, meta = (tdlm.init_params(cfg, seed=0, device=d)
                 for d in ("cpu", "meta"))

    def same(path, c, m):
        assert m.is_meta and (m.shape, m.dtype) == (c.shape, c.dtype), path
    map_with_path(same, cpu, meta)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "xlstm-125m"])
def test_program_cost_memo_prices_as_every_meta_kernel_would(arch):
    """The pricer computes a functional op's meta result once per distinct
    call: a reduced model's training step (forward, remat recompute,
    backward, AdamW) costs the same with every meta kernel run."""
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.launch import specs as tsp
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    cfg = reduce_for_smoke(tget_config(arch))
    opt = AdamWConfig()
    args = (tsp.train_state_struct(cfg, opt),
            tsp.input_specs(cfg, ShapeSpec("small", 32, 2, "train")))
    step = make_train_step(cfg, opt)
    memo, out = program_cost.measure(step, *args)
    full, out_full = program_cost.measure(step, *args, _memo=False)
    assert memo == full
    assert [(t.shape, t.dtype) for t in tleaves(out)] \
        == [(t.shape, t.dtype) for t in tleaves(out_full)]
