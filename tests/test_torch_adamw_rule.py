"""Which leaves AdamW's multi-tensor kernel takes (``kernels/adamw``), on the
CPU: the optimizer picks the kernel by the leaf's device type alone, so
every CPU leaf runs the eager optimizer, counted as eager, whatever its
dtypes and layout; the kernel's domain (``takes_leaf``, ``takes_grads``)
is a pure function of the tensors' dtypes, layout, shapes and devices, and
the binding refuses leaves off the card. ``tests/test_torch_adamw_gpu.py``
holds the kernel to the eager code on the card."""
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import obs
from repro_torch._tree import leaves, tree_map
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.training import optimizer as topt

F32, BF16, F16, F64, I32 = (torch.float32, torch.bfloat16, torch.float16,
                            torch.float64, torch.int32)
DENSE = (True,) * 4
CPU = ("cpu",) * 4


def _tensor(dtype, contiguous, device, shape=(6, 4)):
    """A tensor of ``shape`` (a strided column slice of a wider one where
    not ``contiguous``)."""
    if contiguous:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.zeros(shape[0], 2 * shape[1], dtype=dtype, device=device)[:, ::2]


@pytest.mark.parametrize("dtypes,contiguous,devices,want", [
    ((F32, F32, F32, F32), DENSE, CPU, True),
    ((BF16, BF16, F32, F32), DENSE, CPU, True),
    ((BF16, BF16, BF16, BF16), DENSE, CPU, True),
    ((F16, F16, F32, F32), DENSE, CPU, True),
    ((F16, F16, BF16, BF16), DENSE, CPU, True),
    ((F32, F32, BF16, BF16), DENSE, CPU, True),
    # the domain leaves the device type to the caller: on one device it holds
    ((BF16, BF16, F32, F32), DENSE, ("meta",) * 4, True),
    # p and g of different dtypes
    ((BF16, F32, F32, F32), DENSE, CPU, False),
    # m and v of different dtypes, or a dtype the kernel lacks
    ((BF16, BF16, F32, BF16), DENSE, CPU, False),
    ((F32, F32, F16, F16), DENSE, CPU, False),
    ((F64, F64, F32, F32), DENSE, CPU, False),
    ((F32, F32, F64, F64), DENSE, CPU, False),
    ((I32, I32, F32, F32), DENSE, CPU, False),
    # any tensor not contiguous
    ((F32, F32, F32, F32), (False, True, True, True), CPU, False),
    ((F32, F32, F32, F32), (True, True, True, False), CPU, False),
    # the four on two devices
    ((F32, F32, F32, F32), DENSE, ("cpu", "meta", "cpu", "cpu"), False),
    ((BF16, BF16, F32, F32), DENSE, ("cpu", "cpu", "cpu", "meta"), False),
])
def test_fused_rule(dtypes, contiguous, devices, want):
    leaf = [_tensor(*a) for a in zip(dtypes, contiguous, devices)]
    assert adamw_kernel.takes_leaf(*leaf) is want


def test_fused_rule_wants_one_shape():
    p = torch.zeros(6, 4)
    assert not adamw_kernel.takes_leaf(p, torch.zeros(4, 6), p.clone(), p.clone())
    assert not adamw_kernel.takes_leaf(p, p.clone(), torch.zeros(24), p.clone())


@pytest.mark.parametrize("grads,want", [
    ([], False),
    ([_tensor(F32, True, "cpu"), _tensor(BF16, True, "cpu"),
      _tensor(F16, True, "cpu")], True),
    ([_tensor(F32, True, "cpu"), _tensor(F32, False, "cpu")], False),
    ([_tensor(F64, True, "cpu")], False),
    ([_tensor(BF16, True, "cpu"), _tensor(BF16, True, "meta")], False),
], ids=["empty", "mixed_dtypes", "strided", "fp64", "two_devices"])
def test_norm_rule(grads, want):
    assert adamw_kernel.takes_grads(grads) is want


def _tree(gen, dtype):
    r = lambda *s: torch.randn(*s, generator=gen).to(dtype)
    return {"embed": r(40, 8),
            "blocks": [{"w": r(8, 8), "bias": r(8), "norm": {"scale": r(8)}},
                       {"w": r(8, 16), "bias": r(16)}],
            "head": r(16, 4)}


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_cpu_leaves_go_eager(dtype):
    """CPU leaves run the eager update whether or not the kernel's domain
    holds them (a strided leaf and fp64 leaves beside dense ones), counted
    as eager and bit for bit the functional step."""
    cfg = topt.AdamWConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    gen = torch.Generator().manual_seed(5)
    r = lambda *s, dt=dtype: torch.randn(*s, generator=gen).to(dt)
    params = {"w": r(8, 6), "strided": r(8, 12)[:, ::2], "wide": r(5, dt=F64)}
    assert adamw_kernel.takes_leaf(params["w"], params["w"], params["w"].float(),
                                   params["w"].float())
    assert not params["strided"].is_contiguous()
    state = topt.adamw_init(params)
    donated = tree_map(torch.clone, params)
    dstate = topt.AdamState(*(tree_map(torch.clone, x) for x in state))
    with obs.recording(obs.Recorder()) as rec:
        for _ in range(2):
            grads = {"w": r(8, 6), "strided": r(8, 12)[:, ::2],
                     "wide": r(5, dt=F64)}
            params, state, want = topt.adamw_update(cfg, grads, state, params)
            got = topt.adamw_update_(cfg, grads, dstate, donated)
            assert torch.equal(got["grad_norm"], want["grad_norm"])
    counters = rec.metrics.snapshot()["counters"]
    assert counters["train.optimizer.eager_leaves"] == 6
    assert counters["train.optimizer.fused_leaves"] == 0
    for a, b in zip(leaves(params) + leaves(state.mu) + leaves(state.nu),
                    leaves(donated) + leaves(dstate.mu) + leaves(dstate.nu)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cpu_update_counts_every_leaf_eager(param_dtype, moment_dtype):
    """On the CPU every leaf runs the eager update, counted once a call,
    and the step is bit for bit the functional one, recorder on or off."""
    cfg = topt.AdamWConfig(learning_rate=3e-3, warmup_steps=2, total_steps=6,
                           moment_dtype=moment_dtype)
    gen = torch.Generator().manual_seed(0)
    params = _tree(gen, param_dtype)
    state = topt.adamw_init(params, moment_dtype)
    quiet_p = tree_map(torch.clone, params)
    quiet_s = topt.AdamState(*(tree_map(torch.clone, x) for x in state))
    loud_p = tree_map(torch.clone, params)
    loud_s = topt.AdamState(*(tree_map(torch.clone, x) for x in state))
    n = len(leaves(params))
    with obs.recording(obs.Recorder()) as rec:
        for i in range(3):
            grads = _tree(gen, param_dtype)
            params, state, want = topt.adamw_update(cfg, grads, state, params)
            got = topt.adamw_update_(cfg, grads, loud_s, loud_p)
            with obs.recording(None):
                topt.adamw_update_(cfg, grads, quiet_s, quiet_p)
            assert torch.equal(got["grad_norm"], want["grad_norm"])
    counters = rec.metrics.snapshot()["counters"]
    assert counters["train.optimizer.eager_leaves"] == 3 * n
    assert counters["train.optimizer.fused_leaves"] == 0
    for a, b, c in zip(leaves(params) + leaves(state.mu) + leaves(state.nu),
                       leaves(loud_p) + leaves(loud_s.mu) + leaves(loud_s.nu),
                       leaves(quiet_p) + leaves(quiet_s.mu) + leaves(quiet_s.nu)):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert int(loud_s.step) == int(quiet_s.step) == 3


def test_kernel_refuses_leaves_off_the_card():
    """The binding checks before it hands over a pointer: CPU leaves and
    CPU norms are refused, an empty update is a no-op."""
    t = torch.ones(4)
    s = torch.ones(())
    with pytest.raises(ValueError):
        adamw_kernel.adamw_update_([(t, t, t, t)], [True], None, s, s, s,
                                   b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError):
        adamw_kernel.adamw_update_([(t, t, t, t)], [], None, s, s, s,
                                   b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError):
        adamw_kernel.global_norm([t])
    adamw_kernel.adamw_update_([], [], None, s, s, s, b1=0.9, b2=0.95,
                               eps=1e-8, weight_decay=0.1)
