"""The digests of ``test_seed_sweep.py``'s sweep script, computed in this
process for both packages: every registered training, serving, drift and
colocated scenario and ten generated ones, on GNN-free placers, must
replay the reference's runs byte for byte. (The cross-process replay stays
the reference's own test.)"""
import torch

torch.set_num_threads(1)

from test_seed_sweep import _DRIVER


def _sweep(pkg: str) -> dict:
    ns: dict = {}
    exec(_DRIVER.replace("from repro.", f"from {pkg}."), ns)
    return ns["out"]


def test_seed_sweep_digests_match_reference():
    port, ref = _sweep("repro_torch"), _sweep("repro")
    assert {k.split("/")[0] for k in port} \
        == {"train", "serve", "drift", "colocated", "generated"}
    assert sum(1 for k in port if k.startswith("generated/")) == 10
    assert port == ref
