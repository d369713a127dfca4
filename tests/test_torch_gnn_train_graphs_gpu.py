"""The GNN trainer's captured programs (``core/train.py``'s ``_Trainer``
with ``capture``) on the card, against the same steps run eagerly. Imports
no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_gnn_train_graphs_gpu.py

For each mode (joint, scan, bucketed on a ragged dataset, sequential over
two node counts), two runs of ``train_gnn`` on the card under one key, from
two param sets:

* each gives the params and history of the eager step loop (the same
  trainer without capture) from its params, bit for bit: the replays run
  the kernels the eager steps run, in the same order;
* the second call captures nothing: the cache still holds one trainer,
  with the graphs of the first call;
* the caller's params and the first call's result are left alone;
* ``opt_state.step`` counts the reference's updates (the eager first step
  is applied once, the capture runs nothing);
* the AdamW kernel's launches of a captured run, the first (warm-up,
  capture, replays) and a second one (replays only), are those of the eager
  step loop: every replayed epoch counts the launches its graph holds.

Without a CUDA card every test skips."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import leaves
from repro_torch.core import cost_model as cm
from repro_torch.core import gnn
from repro_torch.core import train as gnn_train
from repro_torch.kernels.adamw import kernel as tadamw

TASKS = [cm.GPT2_1_5B, cm.BERT_LARGE]
STEPS = {"joint": 12, "scan": 4, "bucketed": 4, "sequential": 3}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured programs have no CPU mode")


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _dataset(mode):
    ds = gnn_train.make_dataset(3, TASKS, n_nodes=12, seed=0, label_frac=0.8)
    if mode in ("bucketed", "sequential"):
        ds = ds[:2] + gnn_train.make_dataset(2, TASKS, n_nodes=20, seed=4,
                                             label_frac=0.8)
    return ds


def _eager(cfg, ds, steps, params, mode):
    """The trainer's steps without capture on the card: (params, history,
    updates)."""
    mode, stacks = gnn_train._resolve_mode(ds, mode)
    trainer = gnn_train._Trainer(cfg, gnn_train._opt_config(0.01), mode,
                                 params, ds, stacks, torch.device("cuda"),
                                 capture=False)
    history = trainer.run(steps, ds)
    return trainer.params, history, int(trainer.opt_state.step)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        gnn_train._keyed_leaves(a), gnn_train._keyed_leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(STEPS))
def test_captured_train_gnn_equals_eager_steps(no_tf32, mode):
    _need_cuda()
    cfg = gnn_train.gnn_config_for(TASKS)
    ds = _dataset(mode)
    steps = STEPS[mode]
    d_in = ds[0].feats.shape[1]
    p1, p2 = (gnn.init(cfg, d_in, seed=s, device="cuda") for s in (1, 2))
    keep = [x.clone() for x in leaves(p2)]
    want1, hist1, updates = _eager(cfg, ds, steps, p1, mode)
    want2, hist2, _ = _eager(cfg, ds, steps, p2, mode)
    assert updates == steps * (1 if mode == "joint" else len(ds))

    gnn_train._TRAINERS.clear()
    got1, h1 = gnn_train.train_gnn(cfg, ds, steps=steps, params=p1, mode=mode,
                                   device="cuda")
    (key,) = gnn_train._TRAINERS
    trainer = gnn_train._TRAINERS[key]
    programs = (list(trainer.programs.values()) if mode == "sequential"
                else trainer.programs)
    graphs = [p.graph for p in programs]
    assert all(g is not None for g in graphs)
    assert int(trainer.opt_state.step) == updates
    kept1 = [x.clone() for x in leaves(got1)]

    got2, h2 = gnn_train.train_gnn(cfg, ds, steps=steps, params=p2, mode=mode,
                                   device="cuda")
    assert list(gnn_train._TRAINERS) == [key]
    assert [p.graph for p in programs] == graphs
    assert int(trainer.opt_state.step) == updates
    for got, h, want, hist in ((got1, h1, want1, hist1),
                               (got2, h2, want2, hist2)):
        diff = max(float((a - b).abs().max()) for a, b in zip(
            gnn_train._keyed_leaves(got), gnn_train._keyed_leaves(want)))
        assert _same(got, want), f"{mode}: max |captured - eager| {diff}"
        assert h == hist
    assert not _same(got1, got2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got1), kept1))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p2), keep))
    assert np.isfinite(h2[-1]["loss"]) and h2[-1]["loss"] < h2[0]["loss"]



@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(STEPS))
def test_captured_train_gnn_counts_adamw_in_every_replay(no_tf32, mode):
    _need_cuda()
    cfg = gnn_train.gnn_config_for(TASKS)
    ds = _dataset(mode)
    steps = STEPS[mode]
    params = gnn.init(cfg, ds[0].feats.shape[1], seed=1, device="cuda")
    _graph.reset()
    _eager(cfg, ds, steps, params, mode)
    eager = dict(tadamw.LAUNCHES)
    assert eager["adamw_update"] > 0 and eager["global_norm"] > 0

    gnn_train._TRAINERS.clear()
    for call in ("captures", "only replays"):
        _graph.reset()
        gnn_train.train_gnn(cfg, ds, steps=steps, params=params, mode=mode,
                            device="cuda")
        assert tadamw.LAUNCHES == eager, f"{mode}: the call that {call}"
    (trainer,) = gnn_train._TRAINERS.values()
    programs = (list(trainer.programs.values()) if mode == "sequential"
                else trainer.programs)
    assert all(set(p.graph.held) == set(eager) for p in programs)
