"""Shared helpers of the port's parity tests: the port's GNN cache seeded
with the reference's params, both packages' per-bucket forward caches
emptied at once, the byte-comparable projections of a serving run, and the
models' RUNTIME knobs set on both packages at once.

The reference trains its GNNs from ``jax.random``, which torch cannot
reproduce, so the port's ``trained_gnn`` cache gets the reference's params
(through ``gnn.params_from_numpy``, on the CPU) under the port's own key.
Every metric is compared, ``plan.jit.bucket{b}.compiles`` / ``.cache_hits``
too: each counts against its package's process-wide forward cache, so a
comparison empties both caches (``cold_forwards``) before each package's
run, and the two runs count from the same start.
"""
import contextlib
import dataclasses
import json

import jax
import numpy as np

from repro.core import train as jtrain
from repro.models import common as jcommon
from repro.serve import evaluate as jse
from repro.sim import evaluate as jev
from repro.sim.chaos import canonical_records
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.serve.costs import serve_task_for as t_serve_task_for
from repro_torch.sim import evaluate as tev


def cold_forwards() -> None:
    """Empty both packages' per-bucket forward caches: the next forward of
    every ``(cfg, bucket, d_in)`` is a trace (a ``.compiles``) in each."""
    jtrain._bucketed_forward.cache_clear()
    ttrain._FORWARDS.clear()


def cold(fn):
    """``fn()`` run after ``cold_forwards()``."""
    cold_forwards()
    return fn()


@contextlib.contextmanager
def runtime(**flags):
    """Set the models' RUNTIME knobs on both packages for the block, then
    restore them."""
    old = ({k: jcommon.RUNTIME[k] for k in flags},
           {k: tcommon.RUNTIME[k] for k in flags})
    jcommon.RUNTIME.update(flags)
    tcommon.RUNTIME.update(flags)
    try:
        yield
    finally:
        jcommon.RUNTIME.update(old[0])
        tcommon.RUNTIME.update(old[1])


def to_port(params, cfg):
    """Reference GNN params and config as the port's, on the CPU."""
    return (tgnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu"),
            tgnn.GNNConfig(**dataclasses.asdict(cfg)))


def seed_serve_gnn(ref_model, port_model, n_replicas: int):
    """The reference's ``serve_gnn(ref_model, n)`` under the port's key of
    ``serve_gnn(port_model, n)``; returns the reference's (params, cfg)."""
    params, cfg = jse.serve_gnn(ref_model, n_replicas, seed=0)
    name = t_serve_task_for(port_model, n_replicas).name
    tev._GNN_CACHE[(name,), 0, "analytic"] = to_port(params, cfg)
    return params, cfg


def seed_scenario_gnn(ref_scn, port_scn, label_mode: str = "analytic",
                      with_traffic: bool = True):
    """The reference's ``trained_gnn`` for a scenario's tasks (through its
    own cache) under the port's key, as the port's code asks for it: a
    ``"sim"`` key holds the scenario's jitter, traffic builder (unless the
    caller passes none: ``with_traffic=False``) and comm model, and traffic
    builders hash by identity, so the port's come from the port's scenario.
    Returns the reference's (params, cfg)."""
    def env(scn):
        return (scn.jitter, scn.traffic if with_traffic else None,
                scn.comm_model)
    jitter, traffic, comm_model = env(ref_scn)
    params, cfg = jev.trained_gnn(list(ref_scn.tasks), seed=0,
                                  label_mode=label_mode, jitter=jitter,
                                  traffic=traffic, comm_model=comm_model)
    names = tuple(t.name for t in port_scn.tasks)
    key = ((names, 0, label_mode, *env(port_scn)) if label_mode == "sim"
           else (names, 0, label_mode))
    tev._GNN_CACHE[key] = to_port(params, cfg)
    return params, cfg


def as_json(x) -> str:
    return json.dumps(x, sort_keys=True, default=float)


def result_json(res) -> str:
    """A ``ServeResult`` as canonical JSON."""
    return as_json(res.as_dict())


def raw_json(raw: dict) -> str:
    """Everything a serving run returns but its records (those go through
    ``canonical_records``), as canonical JSON."""
    return as_json({k: v for k, v in raw.items() if k != "records"})


def assert_same_serve_run(ref_raw: dict, port_raw: dict, what: str) -> None:
    """The replica hosts first (a swap of two near-tied GNN scores shows
    here, by name), then the records byte for byte, then every other field
    of the run."""
    hosts = lambda raw: [r["machine"] for r in raw["replicas"]]
    assert hosts(port_raw) == hosts(ref_raw), f"{what}: replica hosts"
    assert canonical_records(port_raw) == canonical_records(ref_raw), what
    assert raw_json(port_raw) == raw_json(ref_raw), what
