"""The port's CUDA graphs of the reference's two hot-path ``jax.jit`` sites,
on the card. Imports no JAX, so that it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graphs_gpu.py

* ``core/train.py``'s bucket graphs (``predict_logits``, ``use_pallas`` on
  and off) at buckets 8, 64, 1024 and 2048: the first call (the eager
  warm-up) and every replay give the eager padded forward's logits bit for
  bit, for two param sets under one cfg; one trace per bucket; the
  ``scaled_spmm`` launches of a replay are counted, 3 a forward (the edge
  pool and two GCN layers), none by the capture.
* ``launch/train.py::TrainGraph``: ``train_loop``'s graphed loop against an
  eager loop of ``make_train_step`` steps of the same length, for reduced
  gemma3-1b, olmoe-1b-7b and whisper-small (fp32, remat on, TF32 off): the
  optimizer's step count equals the number of steps (the warm-up step is
  not applied twice), metrics and params agree at
  ``tests/test_torch_train_step.py``'s tolerances (the two loops run on
  different streams), and the flash launches of the replays are counted
  as an eager loop counts them.
* ``_graph.capture``: one graph whose body launches a flash forward and a
  decode step holds one launch of each module's wrapper; its warm-up
  counts as it runs and each of 3 replays adds what the graph holds to
  each module's ``LAUNCHES``.

Without a CUDA card every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import leaves
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import gnn
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import random_fleet
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.kernels.adamw import kernel as tadamw
from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.gcn_spmm import kernel as tspmm
from repro_torch.launch import train as launch_train
from repro_torch.models import common as tcommon
from repro_torch.models.registry import get_api
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

from _torch_flash_launches import wgmma_share

TOL = 1e-5                            # tests/test_torch_train_step.py
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4   # tests/test_torch_train_step.py
# bucket -> nodes of the graph that lands in it
BUCKET_NODES = {8: 7, 64: 46, 1024: 1000, 2048: 1025}
FAMILIES = ["gemma3-1b", "olmoe-1b-7b", "whisper-small"]
STEPS, BATCH, SEQ, LR = 4, 2, 64, 1e-3


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _eager_padded(params, cfg, graph):
    feats, lat, mask = (torch.from_numpy(a).cuda()
                        for a in gnn_train._pad_graph(graph))
    with torch.no_grad():
        return gnn.apply(params, cfg, feats, lat,
                         node_mask=mask)[:graph.n].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("bucket", sorted(BUCKET_NODES))
def test_bucket_graph_equals_eager_padded_forward(no_tf32, bucket, use_pallas):
    _need_cuda()
    graph = random_fleet(BUCKET_NODES[bucket], seed=bucket)
    assert gnn_train.bucket_for(graph.n) == bucket
    cfg = dataclasses.replace(gnn_train.gnn_config_for([None] * 5),
                              use_pallas=use_pallas)
    d_in = graph.node_features().shape[1]
    p1, p2 = (gnn.init(cfg, d_in, seed=s, device="cuda") for s in (1, 2))
    gnn_train._FORWARDS.clear()
    gnn_train.reset_trace_counts()
    _graph.reset()
    captured = _graph.CAPTURED.copy()
    per_call = 3 if use_pallas else 0
    for calls, params in enumerate((p1, p2, p1, p2), 1):
        want = _eager_padded(params, cfg, graph)
        before = tspmm.LAUNCHES["scaled_spmm"]
        got = gnn_train.predict_logits(params, cfg, graph, device="cuda")
        assert tspmm.LAUNCHES["scaled_spmm"] - before == per_call
        assert got.shape == want.shape and np.array_equal(got, want), \
            f"call {calls}: max |graph - eager| {np.abs(got - want).max()}"
    assert np.abs(gnn_train.predict_logits(p1, cfg, graph, device="cuda")
                  - gnn_train.predict_logits(p2, cfg, graph,
                                             device="cuda")).max() > 1e-3
    assert gnn_train.trace_counts() == {(cfg, bucket): 1}
    (fwd,) = gnn_train._FORWARDS[(cfg, bucket, d_in)].values()
    assert {k: fwd.graph.held.get(k, 0) for k in tspmm.LAUNCHES} == {
        "scaled_spmm": per_call, "spmm": 0}
    assert _graph.CAPTURED["scaled_spmm"] - captured["scaled_spmm"] == per_call
    # four eager forwards and six predicts, each call counted once
    assert tspmm.LAUNCHES["scaled_spmm"] == 10 * per_call


def _causal_layers(cfg) -> int:
    return sum(seg.count * sum(l.kind == "attn" and l.attn.causal
                               for l in seg.layers) for seg in cfg.segments)


def _eager_loop(cfg):
    """``train_loop``'s steps without the graph: the pure
    ``make_train_step`` on the same init, schedule, data and knobs."""
    opt_cfg = topt.AdamWConfig(learning_rate=LR,
                               warmup_steps=min(20, STEPS // 10),
                               total_steps=STEPS)
    state = ttrain_step.init_train_state(cfg, 0, opt_cfg, "cuda")
    step_fn = ttrain_step.make_train_step(cfg, opt_cfg, get_api(cfg))
    data = SyntheticLM(cfg, SyntheticConfig(global_batch=BATCH, seq_len=SEQ,
                                            seed=0))
    history = []
    old = {k: tcommon.RUNTIME[k] for k in ("use_flash", "q_chunk")}
    tcommon.RUNTIME.update(use_flash=True, q_chunk=0)
    try:
        for step, batch in data.iter(0):
            if step >= STEPS:
                break
            state, m = step_fn(state, ttrain_step.device_batch(cfg, batch,
                                                               "cuda"))
            history.append({k: float(v) for k, v in m.items()})
    finally:
        tcommon.RUNTIME.update(old)
    return state, history


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_graphed_train_loop_equals_eager_loop(no_tf32, arch):
    _need_cuda()
    cfg = reduce_for_smoke(get_config(arch))
    assert cfg.remat
    _graph.reset()
    want_state, want = _eager_loop(cfg)
    eager_launches = dict(tflash.LAUNCHES)
    _graph.reset()
    captured = _graph.CAPTURED.copy()
    state, got = launch_train.train_loop(
        cfg, STEPS, BATCH, SEQ, lr=LR, seed=0, log_every=1,
        log=lambda *_: None, device="cuda")
    launches = dict(tflash.LAUNCHES)
    causal = _causal_layers(cfg)
    # per causal layer and step: the forward, its recompute, the backward
    assert launches == eager_launches == {
        "flash_attention": 2 * causal * STEPS,
        "flash_attention.wgmma": wgmma_share(cfg, 2 * causal * STEPS),
        "flash_attention_bwd": causal * STEPS}
    assert {k: _graph.CAPTURED[k] - captured[k] for k in tflash.LAUNCHES} == {
        "flash_attention": 2 * causal,
        "flash_attention.wgmma": wgmma_share(cfg, 2 * causal),
        "flash_attention_bwd": causal}
    # the warm-up step is this loop's first step, not an extra one
    assert int(state.opt.step) == int(want_state.opt.step) == STEPS
    assert [h["step"] for h in got] == list(range(STEPS))
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{arch}: {k} at step {i}")
    for a, b in zip(leaves(state), leaves(want_state)):
        torch.testing.assert_close(a.float(), b.float(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
    assert max((a.float() - b.float()).abs().max().item() for a, b in zip(
        leaves(state.params),
        leaves(get_api(cfg).init_params(cfg, seed=0, device="cuda")))) > 1e-4


@pytest.mark.gpu
def test_one_capture_counts_the_launches_of_two_kernel_modules():
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                      dtype=torch.bfloat16)
    q, k, v = bf16(1, 128, 4, 64), bf16(1, 128, 2, 64), bf16(1, 128, 2, 64)
    dq, dk, dv = bf16(2, 1, 4, 64), bf16(2, 256, 1, 64), bf16(2, 256, 1, 64)
    valid = torch.ones(256, dtype=torch.bool, device="cuda")
    out = {}

    def body():
        out["flash"] = tflash.flash_attention(q, k, v)
        out["decode"] = tdec.decode_attention(dq, dk, dv, valid)

    wgmma = int(tflash.dispatch(64, torch.bfloat16, [], group=2)["body"]
                == "wgmma")
    _graph.reset()
    graph, _ = _graph.capture(body, torch.device("cuda",
                                                 torch.cuda.current_device()))
    held = {"flash_attention": 1, "flash_attention.wgmma": wgmma,
            "flash_attention_bwd": 0, "decode_attention": 1}
    assert graph.held == {k: n for k, n in held.items() if n}
    assert {**tflash.LAUNCHES, **tdec.LAUNCHES} == held   # the warm-up
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert {**tflash.LAUNCHES, **tdec.LAUNCHES} == {
        k: 4 * n for k, n in held.items()}
    assert sum(tspmm.LAUNCHES.values()) + sum(tadamw.LAUNCHES.values()) == 0
    assert torch.equal(out["flash"], tflash.flash_attention(q, k, v))
    assert torch.equal(out["decode"], tdec.decode_attention(dq, dk, dv, valid))
    graph.reset()
