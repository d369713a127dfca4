"""The harness: finds a cell's configuration, traffic mix, limits and
metric readers by name, runs the mix's kind, and prints the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by its name:

  bench/configs/<config>.json    sizes of the model, its source and cuts
  bench/traffic/<traffic>.json   a mix: its ``kind`` and its sizes
  bench/kinds/<kind>.py          ``run(r)``: set-up, window, check
  bench/limits/<cell>.json       the limit of each number compared
  bench/metrics/<metric>.py      ``read(r)``: one per-layer metric, or None

A kind fills the ``Run`` it is given: ``setup_s`` when the window starts,
``e2e`` (end-to-end values by name), ``attempted`` / ``failed``,
``checks`` (number -> value, compared with ``limits``), and in a traced run
``traced`` (a ``trace.Trace``) and ``profiled`` (what the traced stretch
held), which the readers read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    return _module(BENCH / "kinds" / f"{name}.py")


def reader(metric: str):
    return _module(BENCH / "metrics" / f"{metric}.py")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict          # number -> limit
    end_to_end: list      # the spec's end-to-end entries this cell reports
    per_layer: list       # the spec's per-layer entries this cell reports


def cell(spec: dict, name: str) -> Cell:
    """The cell ``name`` of the spec, with its files read."""
    w = {c["name"]: c for c in spec["workloads"]}
    if name not in w:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(w)}")
    c = w[name]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    limits = {k: v["limit"] for k, v in _json("limits", name)["numbers"].items()}
    return Cell(name=name, config=_json("configs", c["config"]),
                traffic=_json("traffic", c["traffic"]), limits=limits,
                end_to_end=e2e, per_layer=per)


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                  # the process's start, perf_counter clock
    setup_s: float | None = None
    e2e: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    traced: trace_mod.Trace | None = None
    profiled: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_process

    def tracer(self):
        return trace_mod.Tracer(self.device)

    def read_peak_memory(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


def execute(c: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float | None = None) -> Run:
    """Run the cell's kind. No look for a card: ``device`` is taken as
    given (the tests drive it on the CPU)."""
    r = Run(cell=c, seed=seed, seconds=seconds, trace=trace,
            device=torch.device(device),
            t_process=time.perf_counter() if t_process is None else t_process)
    kind(c.traffic["kind"]).run(r)
    return r


def correct(r: Run) -> bool:
    missing = set(r.cell.limits) - set(r.checks)
    if missing:
        raise RuntimeError(f"numbers not compared: {sorted(missing)}")
    return all(r.checks[k] <= r.cell.limits[k] for k in r.cell.limits)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def result(r: Run) -> dict:
    """The result line's object; ``checks`` comes last."""
    if r.trace:
        metrics = {}
        for m in r.cell.per_layer:
            v = reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": r.setup_s, "unit": "s"}} if any(
            m["name"] == "setup_s" for m in r.cell.end_to_end) else {}
        for m in r.cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": r.e2e[m["name"]], "unit": m["unit"]}
    dev = r.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu",
              "count": 1, "memory_peak_bytes": r.memory_peak_bytes}
    if dev.type == "cuda":
        device["power"] = power_limit()
    out = {"correct": correct(r), "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": device}
    if r.trace and r.traced is not None:
        device["busy_s"] = r.traced.busy_s
        device["window_s"] = r.traced.window_s
        out["breakdown"] = trace_mod.breakdown(r.traced)
    out["checks"] = {k: {"value": r.checks[k], "limit": r.cell.limits[k]}
                     for k in r.cell.limits}
    return out


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by top
    level name compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
