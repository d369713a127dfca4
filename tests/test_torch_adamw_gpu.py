"""AdamW's multi-tensor kernel (``kernels/adamw``, ``csrc/adamw.cu``) on the
card, against the eager optimizer it replaces. Imports no JAX, so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_adamw_gpu.py

* ``adamw_update_`` (the kernel's update) equals the functional
  ``adamw_update`` (eager kernels, given the same norm) bit for bit over 5
  steps of warmup and cosine: params, ``mu``, ``nu``, ``step``, ``lr`` and
  ``grad_norm``, for every param dtype x moment dtype x clip x decay, on a
  tree of leaves of 1, 7, 3,072 and more than 2^24 elements, and on a tree
  of 150 leaves of mixed sizes and param dtypes, whose tables the passes
  split over several launches (``MAX_LEAVES``); the counters say every
  leaf went fused, and each pass launches once a table.
* A contiguous leaf off the 16-byte grid runs the kernel's element path,
  bit for bit too; a strided leaf is refused (``ValueError``) before
  anything is written.
* One CUDA graph of ``adamw_update_`` replayed 3 times equals 3 calls.
* The kernel's ``global_norm`` equals the eager sum of squares within 1e-6
  and gives the same bits on every call, on both trees; ``squared_sums``
  adds up to its bits, and so a norm over ``DTensor`` shards on a one-card
  NCCL mesh equals the plain leaves' bit for bit.

Without a CUDA card every test skips (the kernel has no CPU mode)."""
from collections import Counter

import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph, obs
from repro_torch._tree import leaves, tree_map
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.training import optimizer as topt

BIG = 4097   # a 4097 x 4097 leaf: 16,785,409 elements, past 2^24, ragged


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW kernel has no CPU mode")


def _tree(gen, dtype):
    """Decayed (``w``, ``embed``) and decay-masked (``bias``, ``scale``)
    leaves of 1, 7, 3,072 and 4097^2 elements, on the card."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return {"embed": r(BIG, BIG),
            "blocks": [{"w": r(64, 48), "bias": r(7), "norm": {"scale": r(3072)}},
                       {"w": r(1), "bias": r(1)}],
            "head": r(48, 7)}


WIDE = 150            # leaves of the wide tree: three tables of MAX_LEAVES
WIDE_SIZES = (1, 7, 3072, 4099, 65537, 130, 0, 2048)


def _wide_tree(gen, dtype):
    """150 leaves of the sizes of ``WIDE_SIZES`` in turn (one of them
    empty), decayed (``w``) and decay-masked (``bias``) in turn; every
    fourth leaf of the next dtype of ``PARAM_DTYPES`` after ``dtype``."""
    dts = adamw_kernel.PARAM_DTYPES
    other = dts[(dts.index(dtype) + 1) % len(dts)]
    return {"layers": [
        {"w" if i % 2 else "bias": torch.randn(
            WIDE_SIZES[i % len(WIDE_SIZES)], generator=gen,
            device="cuda").to(other if i % 4 == 3 else dtype)}
        for i in range(WIDE)]}


TREES = {"small": _tree, "wide": _wide_tree}


def _launches(tree) -> dict:
    """Each pass's launches for one call over ``tree`` (moments of one
    dtype): a table of up to ``MAX_LEAVES`` non-empty leaves of one dtype
    a launch, and the norm's sum."""
    n = Counter(t.dtype for t in leaves(tree) if t.numel())
    tables = sum(-(-k // adamw_kernel.MAX_LEAVES) for k in n.values())
    return {"global_norm": tables + 1, "adamw_update": tables}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(leaves(a), leaves(b)))


def _clone_state(state):
    return topt.AdamState(*(tree_map(torch.clone, x) for x in state))


def _counted(fn):
    """(fn's result, the optimizer's leaf counters while it ran, the
    kernel's launches)."""
    _graph.reset()
    with obs.recording(obs.Recorder()) as rec:
        out = fn()
    got = rec.metrics.snapshot()["counters"]
    return out, {k: got.get(f"train.optimizer.{k}_leaves")
                 for k in ("fused", "eager")}, dict(adamw_kernel.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("decay", [0.1, 0.0], ids=["decay", "no_decay"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16,
                                         torch.float16],
                         ids=["fp32", "bf16", "fp16"])
def test_fused_update_equals_functional(param_dtype, moment_dtype, clip, decay,
                                        tree):
    _need_cuda()
    make = TREES[tree]
    cfg = topt.AdamWConfig(learning_rate=3e-3, weight_decay=decay,
                           grad_clip_norm=clip, warmup_steps=2, total_steps=6,
                           moment_dtype=moment_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = make(gen, param_dtype)
    state = topt.adamw_init(params, moment_dtype)
    donated = tree_map(torch.clone, params)
    dstate = _clone_state(state)
    n_leaves = len(leaves(params))
    for i in range(5):
        # gradients of mixed sizes: clipping bites on some steps only
        grads = tree_map(lambda g: g * 3.0 ** (i - 2), make(gen, param_dtype))
        params, state, want = topt.adamw_update(cfg, grads, state, params)
        got, counters, launches = _counted(
            lambda: topt.adamw_update_(cfg, grads, dstate, donated))
        assert counters == {"fused": n_leaves, "eager": 0}
        assert launches == _launches(grads), (launches, _launches(grads))
        for k in ("lr", "grad_norm"):
            assert torch.equal(got[k], want[k]), (k, i)
        assert _same(donated, params), f"params after step {i}"
        assert _same(dstate.mu, state.mu) and _same(dstate.nu, state.nu), i
        assert torch.equal(dstate.step, state.step)
    assert int(dstate.step) == 5


def _offset(t, k):
    """``t``'s values in a contiguous view ``k`` elements into a fresh
    buffer: dense, but off the 16-byte grid for odd ``k``."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_views_off_the_grid_and_strided(param_dtype):
    """Dense leaves at odd offsets go fused (the kernel's element path), bit
    for bit the functional step; a strided param or gradient on the card is
    refused before anything is written."""
    _need_cuda()
    cfg = topt.AdamWConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(param_dtype)
    params = {"odd": _offset(r(1000), 1), "w": r(33, 5)}
    assert params["odd"].data_ptr() % 16 != 0
    state = topt.adamw_init(params)
    donated = {"odd": _offset(params["odd"], 3), "w": params["w"].clone()}
    dstate = topt.AdamState(state.step.clone(),
                            {k: _offset(v, 1) for k, v in state.mu.items()},
                            tree_map(torch.clone, state.nu))
    for i in range(3):
        grads = {"odd": _offset(r(1000), 5), "w": r(33, 5)}
        params, state, want = topt.adamw_update(cfg, grads, state, params)
        got, counters, _ = _counted(
            lambda: topt.adamw_update_(cfg, grads, dstate, donated))
        assert counters == {"fused": 2, "eager": 0}
        assert torch.equal(got["grad_norm"], want["grad_norm"])
        assert _same(donated, params) and _same(dstate.mu, state.mu), i
        assert _same(dstate.nu, state.nu), i

    base = r(96, 40)
    strided = {"p": base[:, ::2], "g": r(96, 40)[:, ::2]}
    assert not strided["p"].is_contiguous()
    dense = {"p": base[:, ::2].contiguous(), "g": strided["g"].contiguous()}
    for p, g in ((strided["p"], dense["g"]), (dense["p"], strided["g"])):
        ps = {"w": p, "u": r(7)}
        st = topt.adamw_init(ps)
        before = [t.clone() for t in leaves(ps) + leaves(st)]
        with pytest.raises(ValueError):
            topt.adamw_update_(cfg, {"w": g, "u": r(7)}, st, ps)
        assert _same(leaves(ps) + leaves(st), before)


@pytest.mark.gpu
def test_graph_replays_equal_calls():
    _need_cuda()
    cfg = topt.AdamWConfig(learning_rate=3e-3, warmup_steps=2, total_steps=6)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = _tree(gen, torch.bfloat16)
    grads = [_tree(gen, torch.bfloat16) for _ in range(3)]
    state = topt.adamw_init(params)
    eager_p, eager_s = tree_map(torch.clone, params), _clone_state(state)
    for g in grads:
        topt.adamw_update_(cfg, g, eager_s, eager_p)

    static_g = tree_map(torch.clone, grads[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    _graph.reset()
    before = _graph.CAPTURED.copy()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            out = topt.adamw_update_(cfg, static_g, state, params)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    held = {k: _graph.CAPTURED[k] - before[k] for k in adamw_kernel.LAUNCHES}
    assert adamw_kernel.LAUNCHES == {"global_norm": 0, "adamw_update": 0}
    # the norm: one launch of bf16 tiles and the sum; the update: one table
    assert held == {"global_norm": 2, "adamw_update": 1}
    assert int(state.step) == 0          # the capture ran nothing
    for g in grads:
        for dst, src in zip(leaves(static_g), leaves(g)):
            dst.copy_(src)
        graph.replay()
        _graph.count_replays(held)
    torch.cuda.synchronize()
    assert adamw_kernel.LAUNCHES == {k: 3 * n for k, n in held.items()}
    assert _same(params, eager_p)
    assert _same(state.mu, eager_s.mu) and _same(state.nu, eager_s.nu)
    assert int(state.step) == 3 and torch.equal(state.step, eager_s.step)
    assert out["grad_norm"].dtype == torch.float32
    graph.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("tree_name", list(TREES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
def test_global_norm_matches_eager_and_repeats(dtype, tree_name):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    tree = TREES[tree_name](gen, dtype)
    if tree_name == "small":
        tree["blocks"][1]["empty"] = torch.empty(0, dtype=dtype, device="cuda")
    ls = leaves(tree)
    assert adamw_kernel.takes_grads(ls)
    _graph.reset()
    got = topt.global_norm(tree)
    assert adamw_kernel.LAUNCHES == {**_launches(tree), "adamw_update": 0}
    again = topt.global_norm(tree)
    eager = topt._eager_norm(ls)
    exact = torch.sqrt(sum(torch.sum(torch.square(l.double())) for l in ls))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert torch.equal(got, again)
    assert abs(float(got) / float(eager) - 1) <= 1e-6
    assert abs(float(got) / float(exact) - 1) <= 1e-6
    # mixed dtypes in one tree: one launch a dtype, summed in leaf order
    mixed = [ls[0], ls[2].float(), ls[3].to(torch.bfloat16)]
    want = torch.sqrt(sum(torch.sum(torch.square(l.double())) for l in mixed))
    assert abs(float(adamw_kernel.global_norm(mixed)) / float(want) - 1) <= 1e-6
    sums = adamw_kernel.squared_sums(ls)
    assert [t.dtype for t in sums] == [torch.float64] * len(ls)
    empty = [float(t) for t, l in zip(sums, ls) if l.numel() == 0]
    assert empty and set(empty) == {0.0}
    assert torch.equal(torch.sqrt(sum(sums)).float(), got)


@pytest.mark.gpu
def test_sharded_norm_on_one_card_equals_plain():
    """A ``DTensor`` tree on the one-card ``(1, 1)`` mesh (leaves sharded
    and replicated) has the plain tree's norm bit for bit, as the mesh
    loop's step must equal the plain loop's."""
    _need_cuda()
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_mesh_for
    gen = torch.Generator(device="cuda").manual_seed(4)
    tree = _tree(gen, torch.bfloat16)
    want = topt.global_norm(tree)
    mesh = make_mesh_for(1)
    try:
        placed = tree_map(lambda t: distribute_tensor(
            t, mesh, (Shard(0), Replicate()) if t.dim() > 1
            else (Replicate(), Replicate())), tree)
        got = topt.global_norm(placed)
    finally:
        dist.destroy_process_group()
    assert isinstance(leaves(placed)[0], DTensor) and not isinstance(got, DTensor)
    assert got.dtype == torch.float32 and torch.equal(got, want)
