"""GNN-placed serving with the GNN's aggregations on the hand-written CUDA
kernel (``use_pallas=True``) against the same runs with the plain
aggregations, both on the card. Imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_serve_sim_gpu.py

Without a CUDA card every test skips (the kernel has no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _device, _graph
from repro_torch.core.graph import random_fleet
from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.serve import evaluate as tse
from repro_torch.serve.costs import serve_task_for
from repro_torch.serve.router import HulkPlacement
from repro_torch.sim import evaluate as tev
from repro_torch.sim import scenarios as tsc
from repro_torch.sim.chaos import canonical_records


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_gnn(model, n_replicas):
    """The serve GNN trained on the card, and its cache key."""
    params, cfg = tse.serve_gnn(model, n_replicas, seed=0)
    assert _device.of(params).type == "cuda"
    key = ((serve_task_for(model, n_replicas).name,), 0, "analytic")
    return params, dataclasses.replace(cfg, use_pallas=False), key


@pytest.mark.gpu
def test_fused_hulk_serving_equals_plain_on_the_card():
    """``serve_replica_failure`` under the hulk policy: the same replica
    hosts and the same records with the kernel as without it, and the
    kernel launched in whole forwards (3 each)."""
    _need_cuda()
    scn = tsc.get_serve_scenario("serve_replica_failure")
    params, cfg, key = _card_gnn(scn.model, scn.n_replicas)
    runs = {}
    try:
        for use_pallas in (False, True):
            kcfg = dataclasses.replace(cfg, use_pallas=use_pallas)
            tev._GNN_CACHE[key] = (params, kcfg)
            hosts = HulkPlacement(scn.fleet(0), scn.model, scn.n_replicas,
                                  params, kcfg).desired()
            _graph.reset()
            res, raw = tse.run_serve(scn, "hulk", seed=0)
            torch.cuda.synchronize()
            runs[use_pallas] = (hosts, canonical_records(raw), res.as_dict(),
                                tkernel.LAUNCHES["scaled_spmm"])
    finally:
        tev._GNN_CACHE[key] = (params, cfg)
    plain, fused = runs[False], runs[True]
    assert plain[3] == 0
    assert fused[3] > 0 and fused[3] % 3 == 0
    assert fused[0] == plain[0], "replica hosts"
    assert fused[1] == plain[1], "request records"
    assert fused[2] == plain[2]


@pytest.mark.gpu
def test_fused_hulk_scores_equal_plain_at_64_nodes():
    """``HulkPlacement`` on a 64-node fleet: scores within the logits'
    tolerance (1e-5) and the same hosts and runtime group."""
    _need_cuda()
    scn = tsc.get_serve_scenario("serve_replica_failure")
    params, cfg, _ = _card_gnn(scn.model, scn.n_replicas)
    fleet = random_fleet(64, seed=7)
    plain = HulkPlacement(fleet, scn.model, 8, params, cfg)
    _graph.reset()
    fused = HulkPlacement(fleet, scn.model, 8, params,
                          dataclasses.replace(cfg, use_pallas=True))
    assert tkernel.LAUNCHES["scaled_spmm"] > 0
    np.testing.assert_allclose(fused.scores, plain.scores, rtol=0, atol=1e-5)
    assert fused.desired() == plain.desired()
    assert fused.runtime.assignment.groups == plain.runtime.assignment.groups
