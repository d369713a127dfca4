"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback."""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import cost_model as tcm
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.core.graph import paper_fig1_graph
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.kernels.gcn_spmm import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import encdec as tencdec
from repro_torch.models import vlm as tvlm
from repro_torch.runtime import ElasticRuntime
from repro_torch.serve import evaluate as tse
from repro_torch.serve.costs import serve_model_from_task
from repro_torch.serve.router import HulkPlacement
from repro_torch.sim import evaluate as tev

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
print(" ".join(mods))
"""


def test_every_port_module_imports_without_jax_or_repro():
    # a subprocess: this pytest session has imported jax already (conftest)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert len(mods) >= 75          # every module of the slices so far
    for m in ("repro_torch.checkpoint", "repro_torch.checkpoint.manager",
              "repro_torch.launch.train", "repro_torch.training.train_step",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.decode_attention.kernel",
              "repro_torch.runtime", "repro_torch.runtime.elastic",
              "repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.trace", "repro_torch.obs.schema",
              "repro_torch.obs.analysis", "repro_torch.obs.monitors",
              "repro_torch.obs.report", "repro_torch.sim",
              "repro_torch.sim.engine", "repro_torch.sim.compute",
              "repro_torch.sim.network", "repro_torch.sim.faults",
              "repro_torch.runtime.controller", "repro_torch.sim.workload",
              "repro_torch.sim.scenarios", "repro_torch.sim.evaluate",
              "repro_torch.serve", "repro_torch.serve.traffic",
              "repro_torch.serve.costs", "repro_torch.serve.autoscale",
              *SLICE_MODULES, *MODEL_MODULES, *TOOLS_MODULES,
              *EXAMPLE_MODULES):
        assert m in mods, m


# The serving executor's slice: each module imported alone, as the first
# import of a fresh interpreter, so an import cycle between ``sim`` and
# ``serve`` (``sim.scenarios`` reaches ``serve`` at import, ``colocate`` and
# ``generate`` reach back into ``sim``) shows here.
SLICE_MODULES = (
    "repro_torch.serve.resilience", "repro_torch.serve.replica",
    "repro_torch.serve.router", "repro_torch.sim.workload",
    "repro_torch.serve.evaluate", "repro_torch.serve",
    "repro_torch.sim.chaos", "repro_torch.sim.colocate",
    "repro_torch.sim.generate", "repro_torch.sim",
)

# The model zoo's modules: the layer kinds (MoE, MLA, Mamba and xLSTM among
# them), the encoder-decoder and VLM backbones and the registry.
MODEL_MODULES = (
    "repro_torch.models.mlp", "repro_torch.models.attention",
    "repro_torch.models.ssm", "repro_torch.models.xlstm",
    "repro_torch.models.decoder_lm", "repro_torch.models.encdec",
    "repro_torch.models.vlm", "repro_torch.models.registry",
)

# The cost and layout tools: the pricers, the sharding rules, the pipeline,
# the meshes, the specs and the dry-run.
TOOLS_MODULES = (
    "repro_torch.analysis", "repro_torch.analysis.hlo_cost",
    "repro_torch.analysis.roofline", "repro_torch.analysis.program_cost",
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
    "repro_torch.launch.specs", "repro_torch.launch.dryrun",
)

# The compiled paths' modules: the per-bucket forward cache and its CUDA
# graphs, the in-place AdamW, the donating step and the train graph.
GRAPH_MODULES = (
    "repro_torch.core.train", "repro_torch.training.optimizer",
    "repro_torch.training.train_step", "repro_torch.launch.train",
    "repro_torch.kernels.gcn_spmm.kernel",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.decode_attention.kernel",
    "repro_torch.kernels._layout",
)

# Card-only test files: the machine with the card has no JAX, so each must
# import without it (they run there with --noconftest).
CARD_TEST_MODULES = ("test_torch_kernel_domain_gpu", "test_torch_head_dims_gpu")

# The reference's examples as the port's twins.
EXAMPLE_MODULES = (
    "repro_torch.examples", "repro_torch.examples.quickstart",
    "repro_torch.examples.geo_placement", "repro_torch.examples.simulate_fleet",
    "repro_torch.examples.serve_fleet", "repro_torch.examples.trace_run",
    "repro_torch.examples.serve_batch", "repro_torch.examples.train_e2e",
)

_IMPORT_ONE = """
import importlib, sys
mod = importlib.import_module(sys.argv[1])
for name in getattr(mod, "__all__", ()):
    getattr(mod, name)
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
"""


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_model_module_imports_alone_without_jax_or_repro(module):
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", TOOLS_MODULES)
def test_tools_module_imports_alone_without_jax_or_repro(module):
    """Importing one starts no process group and touches no device."""
    code = _IMPORT_ONE + (
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code, module],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", GRAPH_MODULES)
def test_graph_module_imports_alone_without_jax_or_repro(module):
    """Importing one touches no device and builds no kernel: the graphs are
    made at their first call on the card."""
    code = _IMPORT_ONE + (
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code, module],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", CARD_TEST_MODULES)
def test_card_test_file_imports_without_jax_or_repro(module):
    """Importing one touches no device: its cases build their inputs on
    the card when they run."""
    code = _IMPORT_ONE + (
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", code, module],
                          env=dict(os.environ,
                                   PYTHONPATH=os.pathsep.join((SRC, tests_dir))),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", EXAMPLE_MODULES)
def test_example_module_imports_alone_without_jax_or_repro(module):
    """Importing a twin parses no arguments and touches no device."""
    code = _IMPORT_ONE + (
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code, module],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# Four twins run on the CPU as a user runs them, their lazy imports
# included, with neither JAX nor the reference package loaded.
_DRIVE_EXAMPLES = """
import os, sys, tempfile
import torch
torch.set_num_threads(1)
from repro_torch.examples import quickstart, serve_batch, trace_run, train_e2e
tmp = tempfile.mkdtemp()
quickstart.main(["--device", "cpu"])
serve_batch.main(["--device", "cpu"])
trace_run.main(["--device", "cpu", "--time-scale", "0.05",
                "--out", os.path.join(tmp, "t.trace.json")])
train_e2e.main(["--device", "cpu", "--steps", "10",
                "--ckpt-dir", os.path.join(tmp, "ckpt")])
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
"""


def test_examples_run_on_cpu_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _DRIVE_EXAMPLES],
                          env=dict(os.environ, PYTHONPATH=SRC,
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "improvement vs best baseline" in proc.stdout
    assert proc.stdout.count("  request ") == 4
    assert "across a restart (improved)" in proc.stdout


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_serving_slice_module_imports_alone_without_jax_or_repro(module):
    """Every export resolves too: ``serve``'s lazy names load their
    submodules, which must not re-enter a half-built ``repro_torch.sim``."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The lazy imports inside function bodies (sim/evaluate.py's labels import,
# the controller's observed_telemetry_live, labels.py's simulator imports,
# make_example's observed_telemetry) load only when their path runs, so
# drive every one of them before looking at sys.modules.
_DRIVE_LAZY_PATHS = """
import sys
import torch
torch.set_num_threads(1)
from repro_torch.sim import evaluate as ev, scenarios as sc
drift = sc.get_drift_scenario("drift_gray_creep")
for scn, mode in ((drift, drift.label_mode), (sc.get_scenario("cross_region_wan"), "analytic")):
    ev.trained_gnn(list(scn.tasks), seed=0, label_mode=mode, jitter=scn.jitter,
                   traffic=scn.traffic, comm_model=scn.comm_model, device="cpu")
res, ctl = ev.run_drift_scenario(drift, "guarded")
assert ctl.summary()["replans"] >= 1, ctl.summary()
row = ev.evaluate_scenario(sc.get_scenario("cross_region_wan"))
assert row["Hulk"]["makespan_s"] < float("inf"), row
# the serving slice's lazy imports: a Hulk serve run, a chaos case, a
# colocated run and a generated scenario's checks
from repro_torch.serve import evaluate as se
from repro_torch.sim import chaos, colocate, generate
scn = sc.get_serve_scenario("serve_replica_failure")
se.serve_gnn(scn.model, scn.n_replicas, device="cpu")
served, _ = se.run_serve(scn, "hulk")
assert served.n_completed > 0, served
chaos.fuzz_one(0, check_planes=False)
colocate.run_colocated(sc.get_colocated_scenario("colo_wan_steady"),
                       "least_loaded", train_placer="greedy")
generate.check_scenario(generate.generate_scenario(1), planes=False)
for name in ("repro_torch.core.labels", "repro_torch.runtime.controller",
             "repro_torch.serve.costs", "repro_torch.serve.traffic",
             "repro_torch.serve.autoscale", "repro_torch.serve.resilience",
             "repro_torch.serve.router", "repro_torch.serve.replica"):
    assert name in sys.modules, name
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
print(res.makespan, row["Hulk"]["makespan_s"])
"""


def test_sim_paths_run_on_cpu_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _DRIVE_LAZY_PATHS],
                          env=dict(os.environ, PYTHONPATH=SRC,
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    drift_s, hulk_s = map(float, proc.stdout.split())
    assert drift_s > 0 and hulk_s > 0


def _tiny_cpu_setup():
    cfg = tgnn.GNNConfig(hidden=8, n_classes=3)
    graph = paper_fig1_graph()
    feats = graph.node_features()
    ex = ttrain.GraphExample(feats, graph.latency.astype(np.float32),
                             np.zeros(graph.n, np.int64),
                             np.ones(graph.n, np.float32))
    return cfg, graph, ex


ENTRY_POINTS = {
    "init": lambda cfg, g, ex: tgnn.init(cfg, ex.feats.shape[1]),
    "train_gnn": lambda cfg, g, ex: ttrain.train_gnn(cfg, [ex], steps=1),
    "predict_logits": lambda cfg, g, ex: ttrain.predict_logits(
        tgnn.init(cfg, ex.feats.shape[1], device="cpu"), cfg, g),
    "predict": lambda cfg, g, ex: ttrain.predict(
        tgnn.init(cfg, ex.feats.shape[1], device="cpu"), cfg, g),
    # a recovery runtime as a user starts one: params at their default device
    "ElasticRuntime": lambda cfg, g, ex: ElasticRuntime(
        g, tcm.FOUR_TASKS[1:], tgnn.init(cfg, ex.feats.shape[1]), cfg),
    "params_from_numpy": lambda cfg, g, ex: tgnn.params_from_numpy(
        tgnn.params_to_numpy(tgnn.init(cfg, ex.feats.shape[1], device="cpu"))),
    # the evaluator's GNN as a user trains one (a seed no test caches)
    "trained_gnn": lambda *_: tev.trained_gnn(tcm.FOUR_TASKS[1:3], seed=97),
    # the serving GNN as a user trains one, and a Hulk placement over params
    # at their default device
    "serve_gnn": lambda *_: tse.serve_gnn(_CHAT, 2, seed=97),
    "HulkPlacement": lambda cfg, g, ex: HulkPlacement(
        g, _CHAT, 2, tgnn.init(cfg, ex.feats.shape[1]), cfg),
    "lm.init_params": lambda *_: tdlm.init_params(_lm_cfg()),
    "lm.params_from_numpy": lambda *_: tdlm.params_from_numpy(
        tdlm.params_to_numpy(tdlm.init_params(_lm_cfg(), device="cpu"))),
    "lm.init_caches": lambda *_: tdlm.init_caches(_lm_cfg(), 1, 8),
    "encdec.init_params": lambda *_: tencdec.init_params(_cfg("whisper-small")),
    "vlm.init_params": lambda *_: tvlm.init_params(_cfg("internvl2-1b")),
    # a serving session as a user starts one: params at their default device
    "serve_batch": lambda *_: tserve.serve_batch(
        _lm_cfg(), tdlm.init_params(_lm_cfg()),
        {"tokens": np.zeros((1, 4), np.int32)}, 2),
    "serve.main": lambda *_: tserve.main(["--arch", "gemma3-1b", "--smoke"]),
    # a training run as a user starts one
    "train_loop": lambda *_: ttrain_launch.train_loop(_lm_cfg(), 1, 1, 8),
    "train.main": lambda *_: ttrain_launch.main(["--arch", "gemma3-1b", "--smoke"]),
    # a mesh as a user makes one: NCCL on the card unless asked for gloo
    "make_mesh_for": lambda *_: tmesh.make_mesh_for(1),
    "device_mesh": lambda *_: tmesh.device_mesh((1, 1), ("data", "model")),
    # the examples' twins as a user runs them, without --device
    **{f"examples.{name}": (lambda name: lambda *_: importlib.import_module(
        f"repro_torch.examples.{name}").main([]))(name)
       for name in ("quickstart", "geo_placement", "simulate_fleet",
                    "serve_fleet", "trace_run", "serve_batch", "train_e2e")},
}


_CHAT = serve_model_from_task(tcm.ModelTask("Chat-34B", 34e9, 60, 7168),
                              name="chat-34b", decode_efficiency=0.01)


def _cfg(arch: str):
    return reduce_for_smoke(get_config(arch))


def _lm_cfg():
    return _cfg("gemma3-1b")


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_never_fall_back(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, graph, ex = _tiny_cpu_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](cfg, graph, ex)


def test_entry_points_run_on_cpu_when_asked():
    cfg, graph, ex = _tiny_cpu_setup()
    params, hist = ttrain.train_gnn(cfg, [ex], steps=2, device="cpu")
    assert len(hist) == 2
    logits = ttrain.predict_logits(params, cfg, graph, device="cpu")
    assert logits.shape == (graph.n, cfg.n_classes)
    assert np.isfinite(logits).all()


def test_predict_refuses_params_on_another_device():
    cfg, graph, ex = _tiny_cpu_setup()
    params = tgnn.init(cfg, ex.feats.shape[1], device="cpu")
    with pytest.raises(ValueError, match="params lie on"):
        ttrain.predict_logits(params, cfg, graph, device="meta")


def test_kernel_wrapper_refuses_cpu_tensors_instead_of_falling_back():
    a, h = torch.ones(4, 4), torch.ones(4, 3)
    before = dict(tkernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.scaled_spmm(a, h, torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.spmm(a, h)
    assert tkernel.LAUNCHES == before


def test_attention_kernel_wrappers_refuse_cpu_tensors_without_a_launch():
    q, k = torch.ones(1, 8, 2, 16), torch.ones(1, 8, 1, 16)
    before = (dict(tflash_kernel.LAUNCHES), dict(tdec_kernel.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA device"):
        tflash_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        tflash_kernel.flash_attention_bwd(q, k, k, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CUDA device"):
        tdec_kernel.decode_attention(q[:, :1], k, k,
                                     torch.ones(8, dtype=torch.int32))
    assert (tflash_kernel.LAUNCHES, tdec_kernel.LAUNCHES) == before


def test_serve_runs_on_cpu_when_asked(capsys):
    tserve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated shape (2, 3)" in out and "backend=cpu" in out


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_serve_runs_the_audio_and_vlm_families_on_cpu_when_asked(capsys, arch):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated shape (2, 3)" in out and "backend=cpu" in out


def test_train_runs_on_cpu_when_asked(capsys):
    ttrain_launch.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--global-batch", "2", "--seq-len", "16"])
    assert "loss " in capsys.readouterr().out


class _OnOtherDevice:
    """Stands in for a tensor on a device the port does not run on (the CPU
    build of torch can make none): the dispatch reads only ``device``. Meta
    tensors go to the plain version, for shape-only pricing."""
    device = torch.device("xpu")


def test_ops_refuse_devices_other_than_cuda_and_cpu():
    a = h = _OnOtherDevice()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tops.spmm(a, h)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
