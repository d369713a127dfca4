"""The planner twins (``repro_torch.examples.quickstart`` and
``geo_placement``) against the reference's examples.

The reference example runs as it is, its ``train_gnn`` watched; the twin
runs on the CPU with its ``train_gnn`` replaced by the reference's trained
params (through ``gnn.params_from_numpy``) and history, because torch cannot
draw ``jax.random``'s init. The twin must ask for the same training (the
same examples, steps and lr) and print the reference's lines: groups, ids
and the deferred list exactly, makespans and step times at the logits'
parity tolerance. The port's own training is held by
``tests/test_torch_gnn_train_modes.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_examples import assert_same_output, output_of, reference_example
from _torch_parity import cold_forwards
from repro.core import train as jtrain
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.examples import geo_placement, quickstart

TWINS = {"quickstart": quickstart, "geo_placement": geo_placement}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_planner_twin_prints_the_reference_output(name, monkeypatch):
    trained = []
    real = jtrain.train_gnn

    def watched(cfg, ds, **kw):
        out = real(cfg, ds, **kw)
        trained.append((cfg, ds, kw, out))
        return out

    monkeypatch.setattr(jtrain, "train_gnn", watched)
    cold_forwards()
    want = output_of(reference_example(name).main)
    ((jcfg, jds, jkw, (jparams, jhist)),) = trained

    asked = []

    def reference_params(cfg, ds, **kw):
        asked.append((cfg, ds, kw))
        return (tgnn.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu"), jhist)

    monkeypatch.setattr(ttrain, "train_gnn", reference_params)
    cold_forwards()
    got = output_of(TWINS[name].main, ["--device", "cpu"])
    ((cfg, ds, kw),) = asked
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert kw == {**jkw, "device": torch.device("cpu")}
    assert len(ds) == len(jds)
    for a, b in zip(jds, ds):
        for f in ("feats", "lat", "labels", "mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert_same_output(want, got)


def test_quickstart_twin_trains_on_the_cpu_when_asked():
    """The twin's own training, on the CPU: 100 joint steps on the five
    graphs of the reference (the port's init, so its numbers differ from
    the reference's; the plan must still be whole)."""
    lines = output_of(quickstart.main, ["--device", "cpu"])
    assert lines[0] == "fleet: 8 machines, 62 GPUs"
    assert lines[1].startswith("GNN trained: acc ")
    first, last = map(float, lines[1].split("acc ")[1].split(" -> "))
    assert last > first
    assert [l.split()[0] for l in lines if l.split()[:1] in (
        ["Hulk"], ["SystemA"], ["SystemB"], ["SystemC"])] == [
            "Hulk", "SystemA", "SystemB", "SystemC"]
    assert lines[-1].startswith("improvement vs best baseline: ")
