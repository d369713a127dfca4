"""The fleet evaluation's Hulk arm with the GNN's aggregations on the
hand-written CUDA kernel (``use_pallas=True``) against the same arm with
the plain aggregations, both on the card. Imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_sim_eval_gpu.py

Without a CUDA card every test skips (the kernel has no CPU mode)."""
import dataclasses
import json

import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _device, _graph
from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.sim import evaluate as tev
from repro_torch.sim import scenarios as tsc


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cross_region_wan", "preemption_storm"])
def test_fused_hulk_arm_equals_plain_on_the_card(name):
    _need_cuda()
    scn = tsc.get_scenario(name)
    tasks = list(scn.tasks)
    params, cfg = tev.trained_gnn(tasks, seed=0)      # trained on the card
    assert _device.of(params).type == "cuda"
    key = (tuple(t.name for t in tasks), 0, "analytic")
    assert tev._GNN_CACHE[key][0] is params
    rows = {}
    try:
        for use_pallas in (False, True):
            tev._GNN_CACHE[key] = (params, dataclasses.replace(
                cfg, use_pallas=use_pallas))
            _graph.reset()
            row = tev.evaluate_scenario(scn, seed=0)
            torch.cuda.synchronize()
            rows[use_pallas] = (row, tkernel.LAUNCHES["scaled_spmm"])
    finally:
        tev._GNN_CACHE[key] = (params, cfg)
    (plain, plain_launches), (fused, fused_launches) = rows[False], rows[True]
    assert plain_launches == 0
    assert fused_launches > 0 and fused_launches % 3 == 0
    assert json.dumps(fused, sort_keys=True) == json.dumps(plain, sort_keys=True)
