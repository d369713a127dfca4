"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels (``gcn_spmm``, ``flash_attention``
with its backward ``flash_attention_bwd``, ``decode_attention``) from
``src/repro_torch/csrc`` with nvcc, one process per source, and checks each
against its plain PyTorch version. Then it drives the three main paths
through the port's entry points at full width: the planner (hidden 213, two
GCN layers) on fleet46 and a 1024-node fleet, then recovers that fleet
through the elastic runtime (a join, a failure, a leave) and runs the
simulator's network core on the survivors, then scores Hulk against Systems
A/B/C on the simulated fleet's six scenarios, runs the three drift scenarios
under the online re-planning controller, simulates the 1024-node fleet
for 2 steps through a crash that re-plans it, compares nearest /
least-loaded / Hulk routing on the three serving scenarios, runs the
colocated scenarios (a training and a serving tenant on one fabric), the
chaos, controller and generator suites, and serves the 1024-node fleet at
20 requests/s through a replica failure, the Hulk GNN aggregating
through ``gcn_spmm`` in each, inside the per-bucket CUDA graphs of
``core/train.py`` (one "jit" line per phase: the forwards per bucket,
traces and cache hits); serving gemma3-1b (26 layers,
d_model 1152, bf16, random weights from a seed) on 4 prompts of 1024 tokens
with 64 generated, whose decode loop replays one captured CUDA graph of the
decode step; serving olmoe-1b-7b at full width (16 layers, 64 experts top-8,
bf16) the same way, deepseek-v2 at full width cut to 2 layers (MLA in the
plain and the absorbed order, 160 experts top-6), and jamba-1.5-large and
xlstm-125m reduced and xlstm-125m at full size; serving whisper-small (12
encoder and 12 decoder layers, 1,500 frames, prompts of 384) and
internvl2-1b (24 layers, GQA group 7, 256 patches ahead of prompts of 1024)
and phi3-mini (32 layers, d_model 3072, 32 heads of 96: head_dim 96 read
unpadded at the kernels' width 128) at full width, bf16; and training
gemma3-1b (batch 4 x 1024 tokens, remat on,
chunked CE) for 6 steps through ``launch/train.py::train_loop``, which
replays one captured CUDA graph of the donating step (``TrainGraph``), with a
checkpoint every 3 steps, then a fresh loop that resumes from step 3. It
then holds the cost and layout tools to what the card held:
``serve_model_from_config`` priced on the meta device for the four
full-width served models (weight bytes equal to the params', KV bytes to
the caches'), the dry-run on a 1 x 1 mesh (argument bytes at most each
phase's peak), the dry-run of every cell on the production meshes (host
only, in a process of its own beside the card's phases) and gemma3-1b's
params distributed over a one-card NCCL mesh. Every GNN it trains runs
``core/train.py``'s captured programs (one CUDA graph per joint step,
per epoch or per sequential step shape), held to the eager steps; the
seven example twins run as a user runs them. It
times every kernel beside its plain version, a one-call library yardstick
and its bound (the attention kernels also at phi3-mini's head_dim 96 and
at head_dim 80, the backward also split by kernel), runs the card-only pytest files, and prints
one JSON line per phase. Any failure exits non-zero before the last line,
which is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
``repro``.

Phases: build -> kernel check (gcn_spmm) -> fleet46 plan (paper Table 2 /
Fig. 8) -> 1024-node plan -> elastic recovery of that fleet (join to 1025
nodes, i.e. bucket 2048; a failure that forces a re-plan through the GNN; a
leave; launches per event, fused against plain logits at 1025 nodes) ->
the network model on the survivors (both flow solvers, one ring all-reduce
per task) -> the fleet evaluation (``evaluate_all`` twice, launches per
scenario, fused against plain logits on each fleet) -> the drift scenarios
under each controller mode (the sim-labeled GNN trained on the card, a
guarded replay, launches after the initial placement) -> the 1024-node
fleet simulation (launches before, during and after the crash's re-plan) ->
the serving comparison (``evaluate_all_serve`` twice, launches per
placement and per host failure, the plain cfg's Hulk rows) -> the
colocated scenarios x policies (both tenants' GNNs on the card) -> chaos
(``fuzz`` 25 seeds, ``fuzz_controller``, ``generate.fuzz_one`` 0-2) ->
serving at 1024 nodes (launches at the placement, the failure and after;
fused against plain hosts) -> gcn_spmm times and a bit-for-bit repeat at
buckets 1024 and 2048 -> ``predict_logits`` per call through the bucket
graphs against the eager paths (``gnn_graphs``) -> kernel check
(attention) -> every head dim (``head_dims``: D 8, 36, 40, 80, 96, 112,
192, 200, 256 in fp32 and bf16, forward, backward and decode against the
plain versions, one profiled call each holding only the kernel's own
launches, ``force_ref=True`` launching nothing) -> every input the
reference's kernels take (``kernel_domain``: D 257-1024 in column passes
and fp16 on every kernel, views bit for bit the dense call, an fp32
adjacency with bf16 features, query rows that see no key; a profiled
D 320 call per dtype holding only its body's kernels) -> gemma3-1b serve (launch
counts,
a repeat call that must hold no more memory, the graphed step against the
eager one, eager and graphed decode profiles, kernels vs plain in fp32) ->
olmoe-1b-7b serve (launch counts, a repeat call, graphed vs eager,
profiles, fp32 kernels vs plain: the routing decisions compared layer by
layer, then the logits on the rows no routing flip reached) -> deepseek-v2
serve (2 layers, both MLA orders graphed, the fp32 orders' tokens, routing
and logits) -> the small families (jamba and xlstm reduced, xlstm at full
size; graphed vs eager, jamba's kernel launches) -> whisper-small and
internvl2-1b serve (launch counts, a repeat call, graphed vs eager,
profiles, fp32 kernels vs plain on every row) -> phi3-mini serve (the
same checks, head_dim 96 through the kernels unpadded) ->
attention times (decode also per call inside a graph and from HBM; D 512
and fp16 rows naming SDPA's backend) ->
kernel check (flash backward) -> flash backward times -> gemma3-1b train
(launch counts, the resumed losses against the straight run's, a profile
of one step) -> the pricer (``price_serve``) -> the one-card dry-run
(``dryrun_1chip``) -> the production dry-run (``dryrun_production``,
started after the build) -> the one-card mesh (``mesh_1card``) -> the GNN
trainer's captured programs against its eager steps
(``gnn_train_graphs``: fleet46's, the evaluator's and plan_bench's
datasets, a ragged and a scan run; bit for bit, the update count, a second
call that captures nothing, profiles) -> the seven example twins
(``examples``: each ``repro_torch.examples.<name>.main`` on the card, its
launches; serve_batch's tokens against the CPU's) -> card-only pytest ->
kernels summary -> import check.

Launch counts on the serve path, zeroed just before the 64-token call and
read just after it: 26 ``flash_attention`` (one prefill of 26 layers) and
26 x 64 = 1,664 ``decode_attention``: the eager warm-up step before the
capture (26), then 63 replays of a graph that holds one step (26 each);
the capture itself runs nothing. On olmoe-1b-7b's serve path, zeroed the
same way: 16 ``flash_attention`` and 16 x 64 = 1,024 ``decode_attention``;
on reduced jamba's (2 attention layers, 16 generated) 2 and 32;
deepseek-v2 and xlstm launch neither; on whisper-small's, 12 (its decoder's
layers: the encoder is non-causal and plain) and 12 x 64 = 768; on
internvl2-1b's, 24 and 24 x 64 = 1,536; on phi3-mini's, 32 and 32 x 64 =
2,048. On the train path, zeroed just before
the 6 straight steps and read just after: 26 x 2 x 6 = 312
``flash_attention`` (each layer's forward and its recompute under remat)
and 26 x 6 = 156 ``flash_attention_bwd``: the eager first step, then 5
replays of a graph that holds one step; the capture runs nothing. On the
planner's paths a bucket graph's replay counts its 3 ``scaled_spmm``
launches, as the eager forward did. The GNN trainer and the fleet twins
launch no kernel (the plain cfg trains and plans there); the serve_batch
twin's flash and decode launches (reduced gemma3-1b) are counted from zero
around it and listed under ``examples serve_batch``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SOURCES = ("gcn_spmm", "flash_attention", "decode_attention")

CHECK_SHAPES = [(8, 22, "float32"), (46, 15, "float32"), (64, 213, "float32"),
                (128, 213, "float32"), (200, 64, "float32"),
                (1024, 213, "float32"), (2048, 213, "float32"),
                (46, 12, "bfloat16")]
# tests/test_kernels.py::_tol; fp16 carries 3 more mantissa bits than bf16
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 1e-2}
TIMED_BUCKETS = (8, 16, 64, 1024, 2048)
N_TIMED = 60


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def jit_counts(phase: str):
    """Emit, after the block, the per-bucket GNN forwards it ran through
    ``core/train.py``'s cache: ``trace_counts()`` (reset before the block),
    and per bucket the calls, traces (``compiles``) and ``cache_hits``, as
    the recorder counts ``plan.jit.bucket{b}.*`` (read from the cache's
    lookup, so that runs under recorders of their own count too)."""
    from repro_torch.core import train as gnn_train
    real = gnn_train._bucketed_forward
    counts = {"calls": {}, "compiles": {}, "cache_hits": {}}

    def counted(cfg, bucket, *args):
        fwd, traced = real(cfg, bucket, *args)
        for key in ("calls", "compiles" if traced else "cache_hits"):
            counts[key][str(bucket)] = counts[key].get(str(bucket), 0) + 1
        return fwd, traced

    gnn_train.reset_trace_counts()
    gnn_train._bucketed_forward = counted
    try:
        yield counts
    finally:
        gnn_train._bucketed_forward = real
    traces: dict = {}
    for (_, bucket), n in gnn_train.trace_counts().items():
        traces[str(bucket)] = traces.get(str(bucket), 0) + n
    check(traces == counts["compiles"],
          f"{phase}: trace_counts() {traces} against compiles {counts}")
    emit("jit", of=phase, trace_counts=traces, **counts)


def plan_invariants(graph, assignment, tasks) -> None:
    mem = graph.memory_gb()
    by_name = {t.name: t for t in tasks}
    all_ids = [i for ids in assignment.groups.values() for i in ids]
    check(len(all_ids) == len(set(all_ids)), "groups are not disjoint")
    for name, ids in assignment.groups.items():
        check(sum(mem[i] for i in ids) >= by_name[name].min_memory_gb,
              f"group of {name} misses its memory threshold")


def _close(torch, got, want, tol) -> tuple[bool, float]:
    """|got - want| <= tol + tol * |want| everywhere, and the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return bool((diff <= tol + tol * want.abs()).all()), diff.max().item()


def phase_kernel_check(torch, K, R) -> dict:
    """Each kernel against its plain version on GCN-layer inputs: A = 0/1
    mask + I, r = c = (deg A)^-1/2, H normal. ``spmm`` gets the normalized
    A_hat = diag(r) A diag(c), the matrix it multiplies in a GCN layer (on a
    raw 0/1 mask at n = 1024 the sums reach ~90 and any two fp32 sum orders
    differ by ~1e-4)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"scaled_spmm": {}, "spmm": {}}
    for n, d, dt_name in CHECK_SHAPES:
        dt = getattr(torch, dt_name)
        a = ((torch.rand(n, n, device="cuda", generator=gen) < 0.4).float()
             + torch.eye(n, device="cuda")).to(dt)
        h = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        s = (1.0 / torch.sqrt(a.float().sum(1))).to(dt)
        a_hat = (s[:, None] * a * s[None, :]).contiguous()
        for name, got, want in (
                ("scaled_spmm", K.scaled_spmm(a, h, s, s),
                 R.scaled_spmm_ref(a, h, s, s)),
                ("spmm", K.spmm(a_hat, h), R.spmm_ref(a_hat, h))):
            torch.cuda.synchronize()
            got, want = got.float(), want.float()
            tol = TOL[dt_name]
            ok, err = _close(torch, got, want, tol)
            emit("kernel_check", kernel=name, n=n, d=d, dtype=dt_name,
                 max_abs_err=err, max_abs_ref=want.abs().max().item(),
                 rtol=tol, atol=tol, ok=ok)
            check(bool(torch.isfinite(got).all()), f"{name} gave non-finite values")
            check(ok, f"{name} disagrees with its plain version at "
                      f"({n}, {d}, {dt_name}): max abs err {err}")
            errs[name][dt_name] = max(errs[name].get(dt_name, 0.0), err)
    return errs


def _logits_agree(gnn_train, params, kcfg, graph, device) -> float:
    """Fused (``use_pallas``) and plain logits on ``graph`` within
    1e-5 + 1e-5 |plain|; returns their largest difference."""
    plain_cfg = dataclasses.replace(kcfg, use_pallas=False)
    plain = gnn_train.predict_logits(params, plain_cfg, graph, device=device)
    fused = gnn_train.predict_logits(params, kcfg, graph, device=device)
    check(plain.shape == (graph.n, kcfg.n_classes), "logits have the wrong shape")
    check(bool((abs(fused - plain) <= 1e-5 + 1e-5 * abs(plain)).all()),
          f"use_pallas logits disagree with the plain path on {graph.n} nodes")
    return float(abs(fused - plain).max())


def phase_fleet46(torch, device):
    """Paper Table 2 / Fig. 8: train as benchmarks/paper_artifacts._trained,
    then plan and compare with Systems A/B/C through the kernel."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import cost_model as cm
    from repro_torch.core import train as gnn_train
    from repro_torch.core.graph import paper_fleet46
    from repro_torch.kernels.gcn_spmm import kernel as K

    tasks = cm.FOUR_TASKS
    cfg = gnn_train.gnn_config_for(tasks)
    t0 = time.perf_counter()
    ds = gnn_train.make_dataset(4, tasks, n_nodes=46, seed=1, label_frac=0.8)
    fleet = paper_fleet46()
    ds.append(gnn_train.make_example(fleet, tasks, seed=0))
    t_labels = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, hist = gnn_train.train_gnn(cfg, ds, steps=150, lr=0.01,
                                       device=device)
    t_train = time.perf_counter() - t0

    kcfg = dataclasses.replace(cfg, use_pallas=True)
    # end-to-end agreement of the two aggregation paths on the trained model
    logits_diff = _logits_agree(gnn_train, params, kcfg, fleet, device)

    K.reset_launches()
    t0 = time.perf_counter()
    rows = bl.compare_all(fleet, tasks, params, kcfg)
    t_plan = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    a = rows["Hulk"]["assignment"]
    plan_invariants(fleet, a, tasks)
    check(launches["scaled_spmm"] > 0 and launches["scaled_spmm"] % 3 == 0,
          f"scaled_spmm launches {launches['scaled_spmm']} in the fleet46 plan")
    emit("fleet46_plan", labels_s=t_labels, train_s=t_train, plan_s=t_plan,
         final_loss=hist[-1]["loss"], final_accuracy=hist[-1]["accuracy"],
         logits_max_abs_diff_fused_vs_plain=logits_diff,
         groups=a.groups, deferred=a.deferred,
         totals_s={k: float(rows[k]["total"])
                   for k in ("Hulk", "SystemA", "SystemB", "SystemC")},
         improvement_vs_best_baseline=float(rows["improvement_vs_best_baseline"]),
         launches=launches)
    return params, cfg, fleet, launches


def phase_1024(torch, device):
    """paper_artifacts.thousand_node_scale through the kernel."""
    from repro_torch.core import assign as assign_mod
    from repro_torch.core import cost_model as cm
    from repro_torch.core import train as gnn_train
    from repro_torch.core.graph import random_fleet
    from repro_torch.kernels.gcn_spmm import kernel as K

    tasks = cm.SIX_TASKS
    cfg = gnn_train.gnn_config_for(tasks)
    ds = gnn_train.make_dataset(3, tasks, n_nodes=48, seed=21, label_frac=0.8)
    params, hist = gnn_train.train_gnn(cfg, ds, steps=50, lr=0.01,
                                       device=device)
    t0 = time.perf_counter()
    fleet = random_fleet(1024, seed=7)
    t_build = time.perf_counter() - t0
    kcfg = dataclasses.replace(cfg, use_pallas=True)
    K.reset_launches()
    t0 = time.perf_counter()
    a = assign_mod.task_assignments(fleet, tasks, params, kcfg)
    t_assign = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    plan_invariants(fleet, a, tasks)
    check(launches["scaled_spmm"] > 0 and launches["scaled_spmm"] % 3 == 0,
          f"scaled_spmm launches {launches['scaled_spmm']} in the 1024-node plan")
    placed = sum(len(v) for v in a.groups.values())
    emit("plan_1024", final_accuracy=hist[-1]["accuracy"],
         graph_build_s=t_build, assign_s=t_assign, machines_placed=placed,
         deferred=a.deferred, launches=launches)
    return fleet, launches, params, kcfg


def phase_recover_1024(torch, device, params, kcfg, fleet):
    """Elastic recovery (``runtime/elastic.py``, paper §1.1 and §5.2) on the
    1024-node fleet with plan_1024's trained GNN: one machine joins (1025
    nodes: the GNN runs at bucket 2048), then every machine of the largest
    task's group but one fails, so that task drops below its memory floor
    and the spare pool is re-planned through the GNN, then three spare
    machines leave. Each event's launches are zeroed before it and read
    after it, and its host seconds taken around it (the GNN's logits come
    back to the host, which waits for the card)."""
    from repro_torch import obs
    from repro_torch.core import assign as assign_mod
    from repro_torch.core import cost_model as cm
    from repro_torch.core import train as gnn_train
    from repro_torch.core.graph import Machine
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.runtime import ElasticRuntime, FailureEvent

    tasks = cm.SIX_TASKS
    by_name = {t.name: t for t in tasks}
    launches, seconds, metrics, reports = {}, {}, {}, {}

    def event(name, fn):
        rec = obs.Recorder()
        K.reset_launches()
        t0 = time.perf_counter()
        with obs.recording(rec):
            out = fn()
        seconds[name] = time.perf_counter() - t0
        launches[name] = K.LAUNCHES["scaled_spmm"]
        metrics[name] = rec.metrics.snapshot()
        return out

    rt = event("init", lambda: ElasticRuntime(fleet, tasks, params, kcfg))
    plan_invariants(rt.graph, rt.assignment, tasks)
    epochs = [rt.state.epoch]

    reports["join"] = event("join", lambda: rt.on_join(Machine("Tokyo", "A100", 8)))
    joined = rt.graph
    check(joined.n == fleet.n + 1 and gnn_train.bucket_for(joined.n) == 2048,
          f"the joined fleet has {joined.n} nodes")
    check(metrics["join"]["counters"].get("plan.jit.bucket2048.calls", 0) > 0,
          "the join ran no GNN forward at bucket 2048")
    plan_invariants(rt.graph, rt.assignment, tasks)
    epochs.append(rt.state.epoch)
    check(epochs[-1] == epochs[-2] + int(reports["join"]["rebalanced"]),
          f"epochs {epochs} after the join")

    before = {k: list(v) for k, v in rt.assignment.groups.items()}
    n_before = rt.graph.n
    largest = max(before, key=lambda k: by_name[k].params)
    failed = before[largest][1:]
    check(sum(rt.graph.memory_gb()[before[largest][:1]])
          < by_name[largest].min_memory_gb,
          f"one machine of {largest}'s group still holds it")
    reports["recover"] = event("recover", lambda: rt.on_failure(
        FailureEvent(failed_ids=failed, at_step=100)))
    recovered = (rt.graph, rt.assignment)
    plan_invariants(rt.graph, rt.assignment, tasks)
    keep = [i for i in range(n_before) if i not in set(failed)]
    remap = {old: new for new, old in enumerate(keep)}
    check(rt.graph.n == len(keep), "the survivors' graph has the wrong size")
    for name, ids in rt.assignment.groups.items():
        check(all(0 <= i < len(keep) for i in ids)
              and not set(keep[i] for i in ids) & set(failed),
              f"{name}'s group holds a failed machine")
    check(largest in reports["recover"]["affected_tasks"]
          and largest not in rt.assignment.deferred,
          f"{largest} was not re-placed")
    kept = all(rt.assignment.groups.get(name) == sorted(remap[i] for i in ids)
               for name, ids in before.items()
               if name not in reports["recover"]["affected_tasks"])
    if not kept:   # recover fell back to a full re-plan of the survivors
        full = assign_mod.replan_with_deferral(rt.graph, tasks, params, kcfg)
        check((full.groups, full.deferred)
              == (rt.assignment.groups, rt.assignment.deferred),
              "unaffected tasks lost their machines outside a full re-plan")
    epochs.append(rt.state.epoch)
    check(epochs[-1] == epochs[-2] + 1, f"epochs {epochs} after the failure")

    used = {i for ids in rt.assignment.groups.values() for i in ids}
    spare = [i for i in range(rt.graph.n) if i not in used][:3]
    check(len(spare) == 3, "no spare machines left to leave")
    n_before, groups = rt.graph.n, dict(rt.assignment.groups)
    reports["leave"] = event("leave", lambda: rt.on_leave(spare, at_step=200))
    plan_invariants(rt.graph, rt.assignment, tasks)
    epochs.append(rt.state.epoch)
    check(epochs[-1] == epochs[-2] + 1, f"epochs {epochs} after the leave")
    remap = {old: new for new, old in
             enumerate(i for i in range(n_before) if i not in set(spare))}
    check(reports["leave"]["affected_tasks"] == [] and rt.assignment.groups
          == {k: sorted(remap[i] for i in v) for k, v in groups.items()},
          "a leave of spare machines moved a task")

    for name in ("join", "recover"):
        check(launches[name] > 0 and launches[name] % 3 == 0,
              f"scaled_spmm launches {launches[name]} in the {name}")
    logits_diff = _logits_agree(gnn_train, params, kcfg, joined, device)
    # where the join's host time goes: on_join prices the old and the new
    # placement, each through one all-pairs shortest path of the cost model
    t0 = time.perf_counter()
    cm.routed_latency(joined.latency)
    routed_s = time.perf_counter() - t0
    emit("recover_1024", nodes={"init": fleet.n, "joined": joined.n,
                                "survivors": recovered[0].n, "final": rt.graph.n},
         init_s=seconds["init"], join_s=seconds["join"],
         recover_s=seconds["recover"], leave_s=seconds["leave"],
         routed_latency_1025_s=routed_s, launches=launches,
         failed=len(failed), failed_task=largest, unaffected_kept=kept,
         reports=reports, epochs=epochs,
         metrics={k: m["counters"] for k, m in metrics.items()},
         spare_pool={k: m["gauges"].get("plan.assign.spare_pool")
                     for k, m in metrics.items()},
         logits_max_abs_diff_fused_vs_plain_1025=logits_diff,
         deferred=rt.assignment.deferred)
    return launches, joined, recovered


def phase_net_1024(graph, assignment) -> None:
    """The simulator's core at fleet scale, on the host (numpy and scipy):
    on the survivors of recover_1024, each task of the recovered assignment
    (SIX_TASKS)
    starts one ring all-reduce step at t = 0 (each machine of its
    ``stage_order`` sends param_bytes / n to the next), once under each flow
    solver with its own Simulator and Recorder. The two solvers' completion
    times must agree at rel 1e-9 (tests/test_fleet_fast_path.py), their
    metrics outside the solver-specific names exactly, and both traces must
    pass the trace schema."""
    from repro_torch import obs
    from repro_torch.core import cost_model as cm
    from repro_torch.obs import schema
    from repro_torch.sim import NetworkModel, Simulator

    by_name = {t.name: t for t in cm.SIX_TASKS}
    rings = {name: ids for name, ids in sorted(assignment.stage_order.items())
             if len(ids) > 1}
    runs = {}
    for solver in ("fast", "reference"):
        rec = obs.Recorder()
        sim = Simulator(obs=rec)
        t0 = time.perf_counter()
        net = NetworkModel(graph, "alphabeta", solver=solver, obs=rec)
        build_s = time.perf_counter() - t0
        done = {}
        for name, order in rings.items():
            nbytes = by_name[name].param_bytes / len(order)
            for k, src in enumerate(order):
                dst = order[(k + 1) % len(order)]
                sim.schedule(0.0, net.transfer, sim, src, dst, nbytes,
                             (lambda key: lambda: done.__setitem__(
                                 key, sim.now))((name, k)))
        t0 = time.perf_counter()
        makespan = sim.run()
        run_s = time.perf_counter() - t0
        doc = schema.validate_bytes(rec.trace.json_bytes())
        runs[solver] = dict(
            topology_build_s=build_s, run_s=run_s, makespan_s=makespan,
            transfers=len(done), solves=net.n_solves,
            events_dispatched=sim.events_dispatched,
            events_scheduled=sim.events_scheduled,
            trace_events=len(doc["traceEvents"]),
            step_s={name: max(t for (n, _), t in done.items() if n == name)
                    for name in rings},
            done=done, flat=rec.metrics.flat())
    fast, ref = runs["fast"], runs["reference"]
    n_flows = sum(len(v) for v in rings.values())
    check(len(fast["done"]) == len(ref["done"]) == n_flows,
          "a ring transfer did not complete")
    err = max(abs(fast["done"][k] - t) / t for k, t in ref["done"].items())
    check(err <= 1e-9, f"fast and reference completion times differ by {err}")
    semantic = lambda flat: {k: v for k, v in flat.items()
                             if not obs.is_solver_specific(k)}
    check(semantic(fast["flat"]) == semantic(ref["flat"]),
          "the solvers' metrics differ outside the solver-specific names")
    for r in runs.values():
        del r["done"], r["flat"]
    emit("net_1024", nodes=graph.n, rings=len(rings), flows=n_flows,
         max_rel_err=err, rtol=1e-9, **runs)


# -- fleet evaluation and the online controller --------------------------------
def _canonical_fleet(res, controller=None) -> str:
    """Byte-comparable projection of a fleet run and the controller's
    decisions: the reference's ``sim/chaos.py::canonical_fleet``, carried
    here because this script imports nothing of ``repro``."""
    rows = {
        "makespan": float(res.makespan),
        "per_task": {n: {"step_times": [float(t) for t in d["step_times"]],
                         "finish_s": float(d["finish_s"])
                         if d["finish_s"] is not None else None,
                         "failed": bool(d["failed"])}
                     for n, d in sorted(res.per_task.items())},
        "replans": [{"at_s": float(r["at_s"]),
                     "reason": r.get("reason",
                                     "killed" if "killed" in r
                                     else "rejoined")}
                    for r in res.replans],
    }
    if controller is not None:
        rows["log"] = json.loads(json.dumps(controller.summary()["log"],
                                            default=float))
    return json.dumps(rows, sort_keys=True)


def _seed_fused(ev, key):
    """Put the cached GNN of ``key`` back with ``use_pallas=True``, so every
    placement made through it aggregates on the kernel; returns that cfg."""
    params, cfg = ev._GNN_CACHE[key]
    kcfg = dataclasses.replace(cfg, use_pallas=True)
    ev._GNN_CACHE[key] = (params, kcfg)
    return kcfg


def phase_sim_scenarios(device) -> int:
    """The paper's evaluation loop (``sim/evaluate.py::evaluate_all``): Hulk
    against Systems A/B/C on the six ``SCENARIOS`` of the simulated fleet.
    The Hulk arm's GNN is trained on the card (``trained_gnn``), then its
    cache entry is seeded with ``use_pallas=True``, so every Hulk placement
    and fault re-plan aggregates through ``scaled_spmm``. Run 1 evaluates
    one scenario at a time (launches zeroed before each, read after), run 2
    all six in one ``evaluate_all``; they must be equal. Each scenario's
    fleet also checks the fused logits against the plain ones, and one more
    pass with the plain cfg says whether the Hulk makespans agree."""
    from repro_torch.core import train as gnn_train
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.sim import evaluate as ev
    from repro_torch.sim import scenarios as sc

    names = sorted(sc.SCENARIOS)
    tasks = list(sc.get_scenario(names[0]).tasks)
    check(all([t.name for t in sc.get_scenario(n).tasks]
              == [t.name for t in tasks] for n in names),
          "the scenarios do not share one task set")
    key = (tuple(t.name for t in tasks), 0, "analytic")
    t0 = time.perf_counter()
    params, cfg = ev.trained_gnn(tasks, seed=0)
    train_s = time.perf_counter() - t0
    kcfg = _seed_fused(ev, key)

    per, first, launches = {}, {}, 0
    for name in names:
        K.reset_launches()
        t0 = time.perf_counter()
        first.update(ev.evaluate_all(seed=0, names=[name]))
        wall = time.perf_counter() - t0
        n = K.LAUNCHES["scaled_spmm"]
        launches += n
        row = first[name]
        check(n > 0 and n % 3 == 0,
              f"scaled_spmm launches {n} in {name}'s Hulk arm")
        check(math.isfinite(row["Hulk"]["makespan_s"]),
              f"{name}: the Hulk arm did not finish")
        per[name] = dict(
            makespan_s={s: row[s]["makespan_s"]
                        for s in ("Hulk", "SystemA", "SystemB", "SystemC")},
            improvement_vs_best_baseline=row["improvement_vs_best_baseline"],
            replans={s: row[s].get("replans")
                     for s in ("Hulk", "SystemA", "SystemB", "SystemC")},
            wall_s=wall, launches=n,
            logits_max_abs_diff_fused_vs_plain=_logits_agree(
                gnn_train, params, kcfg, sc.get_scenario(name).fleet(0),
                device))
    K.reset_launches()
    t0 = time.perf_counter()
    second = ev.evaluate_all(seed=0)
    all_s = time.perf_counter() - t0
    check(K.LAUNCHES["scaled_spmm"] == launches,
          f"evaluate_all launched {K.LAUNCHES['scaled_spmm']}, "
          f"the scenarios one by one {launches}")
    same = json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True)
    check(same, "two evaluate_all runs of the scenarios differ")
    ev._GNN_CACHE[key] = (params, cfg)
    plain = ev.evaluate_all(seed=0)
    for name in names:
        per[name]["hulk_makespan_equal_plain"] = (
            plain[name]["Hulk"]["makespan_s"] == first[name]["Hulk"]["makespan_s"])
    ev._GNN_CACHE[key] = (params, kcfg)
    wins = {n: first[n]["improvement_vs_best_baseline"] > 0 for n in names}
    emit("sim_scenarios", train_s=train_s, evaluate_all_s=all_s,
         runs_equal=same, launches=launches, scenarios=per,
         hulk_wins=wins, hulk_wins_count=sum(wins.values()),
         table=ev.comparison_table(second))
    return launches


def phase_drift_controller() -> int:
    """The online re-planning controller (``runtime/controller.py``) on the
    three ``DRIFT_SCENARIOS`` under each mode. ``drift_gray_creep`` places
    with the sim-labeled GNN, trained here on the card (sim-refined labels,
    v2 features, 120 steps); both GNNs are seeded with ``use_pallas=True``.
    Each run's launches are zeroed before it and read after it, and split at
    the end of its initial placement: a guarded run that launches after it
    shows the controller's proposals reached the card."""
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.sim import evaluate as ev
    from repro_torch.sim import scenarios as sc

    gray = sc.get_drift_scenario("drift_gray_creep")
    tasks = list(gray.tasks)
    t0 = time.perf_counter()
    ev.trained_gnn(tasks, seed=0, label_mode="sim", jitter=gray.jitter,
                   traffic=gray.traffic, comm_model=gray.comm_model)
    sim_train_s = time.perf_counter() - t0
    _seed_fused(ev, (tuple(t.name for t in tasks), 0, "sim", gray.jitter,
                     gray.traffic, gray.comm_model))
    analytic = (tuple(t.name for t in tasks), 0, "analytic")
    check(ev._GNN_CACHE[analytic][1].use_pallas,
          "the analytic GNN is not seeded with use_pallas")

    marks = {}
    orig_place = ev.HulkPlacer.place

    def place(self, graph):
        out = orig_place(self, graph)
        marks["placed"] = K.LAUNCHES["scaled_spmm"]
        return out

    ev.HulkPlacer.place = place
    runs, projections = {}, {}
    try:
        for name in sorted(sc.DRIFT_SCENARIOS):
            for mode in ("static", "guarded", "unguarded"):
                marks.clear()
                K.reset_launches()
                t0 = time.perf_counter()
                res, ctl = ev.run_drift_scenario(sc.get_drift_scenario(name),
                                                 mode)
                wall = time.perf_counter() - t0
                n = K.LAUNCHES["scaled_spmm"]
                s = ctl.summary() if ctl is not None else {}
                check(math.isfinite(res.makespan),
                      f"{name} under {mode} did not finish")
                check("placed" in marks,
                      f"{name} under {mode} never placed through HulkPlacer")
                runs[f"{name}/{mode}"] = dict(
                    makespan_s=res.makespan, replans=len(res.replans),
                    controller={k: s[k] for k in (
                        "alerts", "suppressed", "replans", "rollbacks",
                        "errors", "gate_rejects")} if s else None,
                    wall_s=wall, launches=n,
                    launches_after_placement=n - marks["placed"])
                projections[name, mode] = _canonical_fleet(res, ctl)
        res2, ctl2 = ev.run_drift_scenario(gray, "guarded")
    finally:
        ev.HulkPlacer.place = orig_place
    replay_same = (_canonical_fleet(res2, ctl2)
                   == projections["drift_gray_creep", "guarded"])
    launches = sum(r["launches"] for r in runs.values())
    emit("drift_controller", sim_label_train_s=sim_train_s, runs=runs,
         guarded_replay_identical=replay_same, launches=launches)
    check(replay_same, "the guarded drift_gray_creep replay differs")
    g, st = runs["drift_gray_creep/guarded"], runs["drift_gray_creep/static"]
    check(g["controller"]["replans"] >= 1 and g["makespan_s"] < st["makespan_s"],
          f"guarded ({g['makespan_s']}) does not beat static "
          f"({st['makespan_s']}) under gray creep")
    check(any(r["launches_after_placement"] > 0 for k, r in runs.items()
              if k.endswith("/guarded")),
          "no guarded run launched scaled_spmm after its initial placement")
    for k, r in runs.items():
        check(r["launches"] > 0 and r["launches"] % 3 == 0,
              f"scaled_spmm launches {r['launches']} in {k}")
    return launches


def phase_sim_1024(params, kcfg) -> int:
    """``FleetSimulation`` at the paper's thousand-node scale:
    ``random_fleet(1024, seed=7)`` with ``SIX_TASKS``, the Hulk arm only
    (``HulkPlacer`` with plan_1024's GNN, ``use_pallas=True``), all tasks
    concurrent, 2 steps. Midway, every machine of the largest task's group
    but one crashes (a ``MachineCrash`` plan), so that task drops below its
    memory floor and ``ElasticRuntime`` re-plans it through the GNN.
    Launches are split at the fault."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.graph import random_fleet
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.runtime import ElasticRuntime
    from repro_torch.sim import FaultPlan, MachineCrash
    from repro_torch.sim import evaluate as ev

    tasks = cm.SIX_TASKS
    by_name = {t.name: t for t in tasks}
    fleet = random_fleet(1024, seed=7)
    groups = ElasticRuntime(fleet, tasks, params, kcfg).assignment.groups
    largest = max(groups, key=lambda k: by_name[k].params)
    victims = tuple(groups[largest][1:])
    check(sum(fleet.memory_gb()[groups[largest][:1]])
          < by_name[largest].min_memory_gb,
          f"one machine of {largest}'s group still holds it")
    placer = ev.HulkPlacer(tasks, params, kcfg)
    marks = {}
    on_failure = placer.on_failure

    def failure(failed_ids, at_step):
        marks["before_fault"] = K.LAUNCHES["scaled_spmm"]
        out = on_failure(failed_ids, at_step)
        marks["fault"] = K.LAUNCHES["scaled_spmm"] - marks["before_fault"]
        return out

    placer.on_failure = failure
    K.reset_launches()
    t0 = time.perf_counter()
    res = ev.FleetSimulation(
        fleet, tasks, placer, steps=2, seed=0, concurrent=True,
        fault_plan=FaultPlan((MachineCrash(at=0.5, machines=victims),))).run()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["scaled_spmm"]
    check("fault" in marks, "the crash never reached the placer")
    emit("sim_1024", nodes=fleet.n, steps=2, wall_s=wall,
         events=res.n_events, events_per_s=res.n_events / wall,
         makespan_s=res.makespan,
         mean_step_s={t: res.mean_step_s(t) for t in res.per_task},
         failed=sorted(t for t, d in res.per_task.items() if d["failed"]),
         replans=len(res.replans), crashed=len(victims), crashed_task=largest,
         survivors=placer.rt.graph.n, deferred=placer.rt.assignment.deferred,
         launches=launches,
         launches_split={"before_fault": marks["before_fault"],
                         "fault_replan": marks["fault"],
                         "after_fault": (launches - marks["before_fault"]
                                         - marks["fault"])})
    check(math.isfinite(res.makespan), "the 1024-node run did not finish")
    check(len(res.replans) == 1 and placer.rt.state.epoch >= 1,
          f"{len(res.replans)} re-plans at 1024 nodes")
    check(marks["before_fault"] > 0 and marks["before_fault"] % 3 == 0
          and marks["fault"] > 0 and marks["fault"] % 3 == 0,
          f"scaled_spmm launches {marks} around the crash")
    return launches


# -- GNN-placed serving, colocation and chaos ---------------------------------
SERVE_POLICIES = ("nearest", "least_loaded", "hulk")
SERVE_METRICS = ("p50_s", "p95_s", "p99_s", "goodput_rps",
                 "slo_violation_rate", "n_completed", "n_dropped")


def _serve_key(model, n_replicas: int) -> tuple:
    """``trained_gnn``'s cache key of ``serve_gnn(model, n_replicas)``."""
    from repro_torch.serve.costs import serve_task_for
    return ((serve_task_for(model, n_replicas).name,), 0, "analytic")


def _serve_gnn_fused(device, model, n_replicas: int) -> tuple:
    """The serve GNN trained on the card (``serve_gnn``), its cache entry
    seeded with ``use_pallas=True``; returns (params, plain cfg, fused cfg,
    seconds of ``serve_gnn``, near 0 on a cache hit)."""
    from repro_torch.serve import evaluate as se
    from repro_torch.sim import evaluate as ev

    key = _serve_key(model, n_replicas)
    t0 = time.perf_counter()
    params, cfg = se.serve_gnn(model, n_replicas, seed=0, device=device)
    train_s = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, use_pallas=False)
    return params, cfg, _seed_fused(ev, key), train_s


def _serve_scores(model, params, cfg, graph):
    """``HulkPlacement``'s per-machine scores of ``graph`` under ``cfg``,
    without building the placement's runtime."""
    import types

    from repro_torch.serve.router import HulkPlacement
    me = types.SimpleNamespace(params=params, cfg=cfg, model=model,
                               external_load=None)
    return HulkPlacement._gnn_scores(me, graph)


def _score_gap(model, params, kcfg, graph) -> dict:
    """Fused against plain serving scores on ``graph``: their largest
    difference, and the smallest gap between two distinct plain scores (a
    pair closer than the difference could swap places in the ranking)."""
    import numpy as np
    plain = _serve_scores(model, params,
                          dataclasses.replace(kcfg, use_pallas=False), graph)
    fused = _serve_scores(model, params, kcfg, graph)
    ranked = np.unique(plain)
    return {"scores_max_abs_diff": float(np.abs(fused - plain).max()),
            "smallest_score_gap": (float(np.diff(ranked).min())
                                   if ranked.size > 1 else None)}


def _first_diff(a, b, path: str = "") -> str | None:
    """The first field (by sorted key) where two JSON-like rows differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            d = _first_diff(a.get(k), b.get(k), f"{path}/{k}")
            if d is not None:
                return d
        return None
    if json.dumps(a, default=float) != json.dumps(b, default=float):
        return f"{path}: {a!r} != {b!r}"
    return None


def _serve_summary(res: dict) -> dict:
    return {k: res[k] for k in SERVE_METRICS}


def _must_replan(placement, machine_id: int) -> bool:
    """Whether losing ``machine_id`` leaves the serve group of
    ``placement``'s runtime below its memory floor, so that
    ``core.assign.recover`` re-plans it through the GNN (a group that stays
    above its floor only loses the machine)."""
    if machine_id not in placement.rt2fleet:
        return False
    rt_id = placement.rt2fleet.index(machine_id)
    ids = placement.runtime.assignment.groups.get(placement.task.name, [])
    if rt_id not in ids:
        return False
    mem = placement.runtime.graph.memory_gb()
    return (sum(float(mem[i]) for i in ids if i != rt_id)
            < placement.task.min_memory_gb)


@contextlib.contextmanager
def _placement_marks(K):
    """Splits ``scaled_spmm``'s launches at ``HulkPlacement``'s events: each
    construction (the runtime's plan and the first scores, with the hosts
    it chose) and each host failure (its recovery, with whether it had to
    re-plan through the GNN)."""
    from repro_torch.serve import router

    marks = {"placements": [], "failures": []}
    orig_init = router.HulkPlacement.__init__
    orig_failed = router.HulkPlacement.on_machine_failed

    def init(self, *args, **kwargs):
        before = K.LAUNCHES["scaled_spmm"]
        orig_init(self, *args, **kwargs)
        marks["placements"].append(dict(
            launches=K.LAUNCHES["scaled_spmm"] - before,
            hosts=list(self.active)))

    def failed(self, machine_id):
        must = _must_replan(self, machine_id)
        before = K.LAUNCHES["scaled_spmm"]
        orig_failed(self, machine_id)
        marks["failures"].append(dict(
            machine=machine_id, must_replan=must,
            launches=K.LAUNCHES["scaled_spmm"] - before))

    router.HulkPlacement.__init__ = init
    router.HulkPlacement.on_machine_failed = failed
    try:
        yield marks
    finally:
        router.HulkPlacement.__init__ = orig_init
        router.HulkPlacement.on_machine_failed = orig_failed


def _check_failures(marks, where: str) -> None:
    """A host failure launches the kernel exactly when its recovery must
    re-plan through the GNN, and in whole forwards (3 launches each)."""
    for f in marks["failures"]:
        check(f["launches"] % 3 == 0
              and (f["launches"] > 0) == f["must_replan"],
              f"{where}: the failure of host {f['machine']} launched "
              f"{f['launches']} (must re-plan: {f['must_replan']})")


def phase_serve_scenarios(device) -> int:
    """The serving comparison (``serve/evaluate.py::evaluate_all_serve``):
    nearest, least_loaded and Hulk on the three ``SERVE_SCENARIOS``. The
    serve GNN is trained on the card by ``serve_gnn``, then its cache entry
    is seeded with ``use_pallas=True``, so ``HulkPlacement``'s runtime and
    scores aggregate through ``scaled_spmm``. Run 1 evaluates one scenario
    at a time (launches zeroed before each, read after), run 2 all three in
    one ``evaluate_all_serve``; they must be equal. One more pass with the
    plain cfg says whether the Hulk rows agree, and where they do not, the
    first field that differs and the score gap behind it."""
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.serve import evaluate as se
    from repro_torch.sim import evaluate as ev
    from repro_torch.sim import scenarios as sc

    names = sorted(sc.SERVE_SCENARIOS)
    gnns, train_s = {}, {}
    for name in names:
        scn = sc.get_serve_scenario(name)
        key = _serve_key(scn.model, scn.n_replicas)
        if key not in gnns:
            params, cfg, kcfg, train_s[key[0][0]] = _serve_gnn_fused(
                device, scn.model, scn.n_replicas)
            gnns[key] = (params, cfg, kcfg)

    per, first, launches = {}, {}, 0
    for name in names:
        scn = sc.get_serve_scenario(name)
        K.reset_launches()
        with _placement_marks(K) as marks:
            t0 = time.perf_counter()
            first[name] = se.evaluate_serve_scenario(scn, seed=0)
            wall = time.perf_counter() - t0
        n = K.LAUNCHES["scaled_spmm"]
        launches += n
        row = first[name]
        check(n > 0 and n % 3 == 0,
              f"scaled_spmm launches {n} in {name}'s Hulk run")
        _check_failures(marks, name)
        check(all(row[p]["n_completed"] > 0 for p in SERVE_POLICIES),
              f"{name}: a policy completed no request")
        params, _, kcfg = gnns[_serve_key(scn.model, scn.n_replicas)]
        per[name] = dict(
            wall_s=wall, launches=n,
            launches_placement=[m["launches"] for m in marks["placements"]],
            failures=marks["failures"], n_requests=row["n_requests"],
            slo_s=row["slo_s"],
            policies={p: _serve_summary(row[p]) for p in SERVE_POLICIES},
            hulk_vs_nearest=row["hulk_vs_nearest"],
            **_score_gap(scn.model, params, kcfg, scn.fleet(0)))
    K.reset_launches()
    t0 = time.perf_counter()
    second = se.evaluate_all_serve(seed=0)
    all_s = time.perf_counter() - t0
    check(K.LAUNCHES["scaled_spmm"] == launches,
          f"evaluate_all_serve launched {K.LAUNCHES['scaled_spmm']}, "
          f"the scenarios one by one {launches}")
    same = (json.dumps(first, sort_keys=True, default=float)
            == json.dumps(second, sort_keys=True, default=float))
    check(same, "two evaluate_all_serve runs differ")
    for key, (params, cfg, _) in gnns.items():
        ev._GNN_CACHE[key] = (params, cfg)
    plain = se.evaluate_all_serve(seed=0)
    for key, (params, _, kcfg) in gnns.items():
        ev._GNN_CACHE[key] = (params, kcfg)
    for name in names:
        diff = _first_diff(plain[name]["hulk"], first[name]["hulk"])
        per[name]["hulk_equal_plain"] = diff is None
        if diff is not None:
            per[name]["hulk_first_diff_plain"] = diff
    emit("serve_scenarios", serve_gnn_train_s=train_s,
         evaluate_all_serve_s=all_s, runs_equal=same, launches=launches,
         scenarios=per, table=se.serve_comparison_table(second))
    return launches


def phase_colocated(device) -> int:
    """Both tenants on one fabric (``sim/colocate.py::run_colocated``): the
    three ``COLOCATED_SCENARIOS`` under each serve policy, the training
    tenant placed by ``HulkPlacer`` (``train_placer="hulk"``), the serving
    tenant by ``HulkPlacement`` under the hulk policy. Both GNNs are trained
    on the card and seeded with ``use_pallas=True``; launches are zeroed
    before each run and read after it."""
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.sim import colocate as co
    from repro_torch.sim import evaluate as ev
    from repro_torch.sim import scenarios as sc

    runs, train_s, launches = {}, {}, 0
    for name in sorted(sc.COLOCATED_SCENARIOS):
        scn = sc.get_colocated_scenario(name)
        _serve_gnn_fused(device, scn.model, scn.n_replicas)
        tasks = list(scn.tasks)
        t0 = time.perf_counter()
        ev.trained_gnn(tasks, seed=0, label_mode=scn.label_mode,
                       jitter=scn.jitter, comm_model=scn.comm_model,
                       device=device)
        train_s[name] = time.perf_counter() - t0
        names = tuple(t.name for t in tasks)
        _seed_fused(ev, (names, 0, "sim", scn.jitter, None, scn.comm_model)
                    if scn.label_mode == "sim" else (names, 0, "analytic"))
        for policy in SERVE_POLICIES:
            K.reset_launches()
            t0 = time.perf_counter()
            res = co.run_colocated(scn, policy, seed=0, train_placer="hulk")
            wall = time.perf_counter() - t0
            n = K.LAUNCHES["scaled_spmm"]
            launches += n
            co.check_colocated_invariants(res, scn)
            check(n > 0 and n % 3 == 0,
                  f"scaled_spmm launches {n} in {name}/{policy}")
            runs[f"{name}/{policy}"] = dict(
                wall_s=wall, launches=n, invariants_hold=True,
                serve=_serve_summary(res["serve"].as_dict()),
                train_makespan_s=res["train"].makespan,
                train_hosts=res["train_hosts"], serve_hosts=res["serve_hosts"],
                overlap=len(res["overlap"]))
    emit("colocated", label_modes={n: sc.get_colocated_scenario(n).label_mode
                                   for n in sorted(sc.COLOCATED_SCENARIOS)},
         train_gnn_s=train_s, runs=runs, launches=launches)
    return launches


def phase_chaos() -> int:
    """The robustness suites: ``chaos.fuzz`` over 25 random fault plans (host
    only: both serving paths, determinism, fast == reference plane,
    exactly-once), the controller suite ``chaos.fuzz_controller`` over the
    drift scenarios (its GNNs, from the ``sim_scenarios`` and
    ``drift_controller`` phases, seeded with ``use_pallas=True``; launches
    zeroed before and read after), and ``generate.fuzz_one`` on seeds 0-2
    (each generated scenario's declared invariants). Every suite raises on
    its first violation."""
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.sim import chaos
    from repro_torch.sim import evaluate as ev
    from repro_torch.sim import generate
    from repro_torch.sim import scenarios as sc

    t0 = time.perf_counter()
    fz = chaos.fuzz(n_seeds=25, log=lambda line: None)
    fuzz_s = time.perf_counter() - t0
    check(fz["violations"] == 0 and len(fz["cases"]) == 25,
          f"chaos.fuzz: {fz['violations']} violations")
    for name in sorted(sc.DRIFT_SCENARIOS):
        scn = sc.get_drift_scenario(name)
        names = tuple(t.name for t in scn.tasks)
        key = ((names, 0, "sim", scn.jitter, scn.traffic, scn.comm_model)
               if scn.label_mode == "sim" else (names, 0, "analytic"))
        check(key in ev._GNN_CACHE and ev._GNN_CACHE[key][1].use_pallas,
              f"{name}'s GNN is not cached with use_pallas")
    K.reset_launches()
    t0 = time.perf_counter()
    ctl = chaos.fuzz_controller(seed=0, log=lambda line: None)
    controller_s = time.perf_counter() - t0
    launches = K.LAUNCHES["scaled_spmm"]
    check(ctl["violations"] == 0, "chaos.fuzz_controller found a violation")
    check(launches > 0 and launches % 3 == 0,
          f"scaled_spmm launches {launches} in fuzz_controller")
    generated = {}
    for seed in range(3):
        t0 = time.perf_counter()
        out = generate.fuzz_one(seed)
        check(bool(out["invariants"]), f"generated seed {seed} declares none")
        generated[out["name"]] = dict(kind=out["kind"],
                                      invariants=out["invariants"],
                                      wall_s=time.perf_counter() - t0)
    naive = [c["naive"] for c in fz["cases"]]
    resil = [c["resilient"] for c in fz["cases"]]
    emit("chaos", fuzz_seeds=len(fz["cases"]), fuzz_s=fuzz_s,
         violations=fz["violations"],
         offered=sum(c["offered"] for c in naive),
         completed_naive=sum(c["completed"] for c in naive),
         completed_resilient=sum(c["completed"] for c in resil),
         controller_s=controller_s, controller_cases=ctl["cases"],
         launches=launches, generated=generated)
    return launches


SERVE_1024 = dict(nodes=1024, fleet_seed=7, scenario="serve_replica_failure",
                  rate_rps=20.0, n_replicas=8, max_replicas=12,
                  fault_fracs=(0.4,), seed=0)


def phase_serve_1024(device) -> int:
    """GNN-placed serving at fleet scale: ``random_fleet(1024, seed=7)`` with
    ``serve_replica_failure``'s model (chat-34b), traffic builder and SLO at
    20 requests/s over its 300 s horizon, 8 replicas, its autoscaler up to
    12 within the fleet (no spare machines: a join prices two 1025-node
    all-pairs Dijkstras), one replica killed at 40% of the run; the hulk
    policy only, through ``run_serve``. The serve GNN is trained on the card
    and seeded with ``use_pallas=True``. Launches are split into the
    placement (the runtime's plan and the first scores), the fault's
    recovery (which re-plans through the GNN exactly when the lost host
    leaves the serve group below its memory floor), and the rest; the hosts
    the fused scores choose must equal those the plain scores choose."""
    import numpy as np

    from repro_torch.core.graph import random_fleet
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.serve import evaluate as se
    from repro_torch.serve import router
    from repro_torch.sim import scenarios as sc

    c = SERVE_1024
    base = sc.get_serve_scenario(c["scenario"])
    fleet = random_fleet(c["nodes"], seed=c["fleet_seed"])
    traffic = dataclasses.replace(base.traffic(fleet), rate_rps=c["rate_rps"])
    scn = dataclasses.replace(
        base, name="serve_1024", fleet=lambda seed: fleet,
        traffic=lambda graph: traffic, n_replicas=c["n_replicas"],
        autoscale=dataclasses.replace(base.autoscale,
                                      max_replicas=c["max_replicas"]),
        fault_fracs=c["fault_fracs"], spares=())
    params, cfg, kcfg, train_s = _serve_gnn_fused(device, scn.model,
                                                  scn.n_replicas)

    K.reset_launches()
    with _placement_marks(K) as marks:
        t0 = time.perf_counter()
        res, _ = se.run_serve(scn, "hulk", seed=c["seed"])
        wall = time.perf_counter() - t0
    launches = K.LAUNCHES["scaled_spmm"]
    check(len(marks["placements"]) == 1,
          f"{len(marks['placements'])} Hulk placements")
    fused_hosts = marks["placements"][0]["hosts"]
    fault = sum(f["launches"] for f in marks["failures"])
    split = {"placement": marks["placements"][0]["launches"],
             "fault_replan": fault,
             "rest": launches - marks["placements"][0]["launches"] - fault}

    plain = _serve_scores(scn.model, params, cfg, fleet)
    fused = _serve_scores(scn.model, params, kcfg, fleet)
    elig = router._eligible(fleet, scn.model)
    plain_hosts = sorted(elig, key=lambda i: (-float(plain[i]), i))
    plain_hosts = plain_hosts[:c["n_replicas"]]
    ranked = np.sort(plain[elig])[::-1]
    emit("serve_1024", **c, requests=res.n_requests, wall_s=wall,
         serve_gnn_train_s=train_s, events=res.n_events,
         events_per_s=res.n_events / wall,
         **_serve_summary(res.as_dict()), n_incomplete=res.n_incomplete,
         scale_events=res.scale_events, final_replicas=res.final_replicas,
         failures=marks["failures"], launches=launches, launches_split=split,
         hosts_fused=fused_hosts, hosts_plain=plain_hosts,
         scores_max_abs_diff=float(np.abs(fused - plain).max()),
         host_margin=float(ranked[c["n_replicas"] - 1]
                           - ranked[c["n_replicas"]]))
    check(res.n_completed > 0 and math.isfinite(res.p95_s),
          "the 1024-node serving run completed nothing")
    check(marks["failures"], "the fault never reached the placement")
    _check_failures(marks, "serve_1024")
    check(all(n % 3 == 0 for n in split.values()) and split["placement"] > 0,
          f"scaled_spmm launches {split} around the fault")
    check(fused_hosts == plain_hosts,
          f"fused hosts {fused_hosts} != plain hosts {plain_hosts}")
    return launches


def _gcn_inputs(torch, params, cfg, graph, device):
    """The first GCN layer's aggregation inputs for ``graph`` as the planner
    builds them: A + I of the bucket-padded mask, its (deg)^-1/2, and the
    edge-pool output H."""
    from repro_torch.core import gnn
    from repro_torch.core import train as gnn_train
    feats, lat, node_mask = (torch.from_numpy(x).to(device)
                             for x in gnn_train._pad_graph(graph))
    with torch.no_grad():
        h = gnn.edge_pool(params, cfg, feats, lat, node_mask)
        a, inv_sqrt = gnn._with_self_loops(gnn.edge_mask(lat, node_mask,
                                                         feats.dtype))
    return a.contiguous(), h.contiguous(), inv_sqrt.contiguous()


def _time_ms(torch, fn) -> float:
    """Median device time of one call over N_TIMED calls, CUDA events around
    each. A sleep kernel queued first keeps the host's launch cost out."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _time_graphed_ms(torch, fn, launches=100, replays=7) -> float:
    """Mean device time per call with no per-call event or launch cost: one
    CUDA graph of ``launches`` back-to-back calls, the median over
    ``replays`` replays, each between two events. A kernel wrapper counts
    these calls as captured, not as launches on the main path."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    graph.reset()
    return statistics.median(times)


FLUSH_BYTES = 96 << 20   # past the H100's 50 MB L2


def _time_cold_ms(torch, fn, flush, n=30) -> float:
    """Median device time of one call, CUDA events around each, with a
    write of FLUSH_BYTES before each so that its inputs come from HBM, as on
    the decode path, where 26 layers' caches and ~2 GB of weights pass
    between two visits to one layer. A sleep kernel queued first keeps the
    host's launch cost out, as in ``_time_ms``."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_times(torch, K, R, params, cfg, graphs, device, card) -> dict:
    """Kernel, plain version, one-library-call yardstick and bound, at the
    main path's buckets 8 (cross_region_wan's fleet) and 16
    (preemption_storm's), where the fleet evaluation and the controller
    place, 64 (paper_fleet46), 1024 (random_fleet(1024)) and 2048 (that
    fleet after recover_1024's join, 1025 nodes). At buckets 1024
    (split-K over a cluster) and 2048 two kernel calls must agree bit for
    bit."""
    out = {}
    for b in TIMED_BUCKETS:
        a, h, s = _gcn_inputs(torch, params, cfg, graphs[b], device)
        check(a.shape == (b, b) and h.shape[1] == cfg.hidden,
              f"unexpected bucket shape {tuple(a.shape)}")
        m, n = a.shape
        d = h.shape[1]
        elt = h.element_size()
        nnz = int((a != 0).sum().item())
        a_scaled = (s[:, None] * a * s[None, :]).contiguous()
        cases = {
            "scaled_spmm": dict(
                kernel=lambda: K.scaled_spmm(a, h, s, s),
                plain=lambda: R.scaled_spmm_ref(a, h, s, s),
                library=lambda: torch.matmul(a_scaled, h),
                nbytes=(m * n + n * d + m + n + m * d) * elt,
                # the product over A's nonzeros, c on each, r on each output
                flops=2 * nnz * d + nnz + m * d),
            "spmm": dict(   # the GCN layer's A_hat @ H
                kernel=lambda: K.spmm(a_scaled, h),
                plain=lambda: R.spmm_ref(a_scaled, h),
                library=lambda: torch.matmul(a_scaled, h),
                nbytes=(m * n + n * d + m * d) * elt,
                flops=2 * nnz * d),
        }
        for name, c in cases.items():
            t_bytes = c["nbytes"] / PEAK_BYTES_PER_S * 1e3
            t_ops = c["flops"] / PEAK_FP32_FLOPS * 1e3
            row = {"bucket": b, "n_real": graphs[b].n, "d": d, "nnz": nnz,
                   "ms": _time_ms(torch, c["kernel"]),
                   "plain_ms": _time_ms(torch, c["plain"]),
                   "library_ms": _time_ms(torch, c["library"]),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": c["nbytes"], "flops": c["flops"]}
            if name == "scaled_spmm":   # per call inside a graph of 100
                row["ms_graphed"] = _time_graphed_ms(torch, c["kernel"])
            emit("times", kernel=name, card=card, **_shares(row))
            out.setdefault(name, {})[b] = row
            if b >= 1024:   # split-K over a cluster: no atomics, same bits
                first, second = c["kernel"](), c["kernel"]()
                torch.cuda.synchronize()
                same = torch.equal(first, second)
                emit("determinism", kernel=name, bucket=b, bit_identical=same)
                check(same, f"two {name} calls at bucket {b} differ")
    return out


GRAPH_BUCKETS = (64, 1024, 2048)
N_CALLS = 30


def _per_call_ms(torch, fn, n=N_CALLS) -> tuple[float, float]:
    """Median host ms (the host clock around a call, which ends in a
    blocking copy of the logits to the host) and device ms (CUDA events on
    the current stream around it) of one call, after two warm calls."""
    fn()
    fn()
    host, dev = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def phase_gnn_graphs(torch, device, params, cfg, graphs, card) -> dict:
    """``predict_logits`` per call at buckets 64 (paper_fleet46), 1024
    (random_fleet(1024)) and 2048 (that fleet after the join, 1025 nodes),
    with fleet46's trained GNN and ``use_pallas``: through the bucket's
    CUDA graph (``bucketed=True``, captured by an earlier call), the legacy
    eager forward on the unpadded graph (``bucketed=False``) and the eager
    padded forward (what ``predict_logits`` ran before it had bucket
    graphs: pad on the host, copy in, ``gnn.apply``, copy the logits out).
    Each as host ms and device ms per call (``_per_call_ms``), and the
    forward alone as device time (``_time_ms``): one replay against
    ``gnn.apply`` on the graph's static inputs. The graph's logits equal
    the eager padded forward's bit for bit."""
    import numpy as np
    from repro_torch.core import gnn
    from repro_torch.core import train as gnn_train

    kcfg = dataclasses.replace(cfg, use_pallas=True)
    out = {}
    for b in GRAPH_BUCKETS:
        graph = graphs[b]

        def eager_padded(graph=graph):
            f, l, m = (torch.from_numpy(a).to(device)
                       for a in gnn_train._pad_graph(graph))
            with torch.no_grad():
                logits = gnn.apply(params, kcfg, f, l, node_mask=m)
            return logits[:graph.n].cpu().numpy()

        graphed = lambda graph=graph: gnn_train.predict_logits(
            params, kcfg, graph, device=device)
        unpadded = lambda graph=graph: gnn_train.predict_logits(
            params, kcfg, graph, bucketed=False, device=device)
        got, want = graphed(), eager_padded()
        check(np.array_equal(got, want), f"bucket {b}: the graph's logits "
              f"differ from the eager padded forward's by "
              f"{float(np.abs(got - want).max())}")
        d_in = gnn.d_in_of(params)
        (fwd,) = gnn_train._FORWARDS[(kcfg, b, d_in)].values()
        check(fwd.graph is not None, f"bucket {b} has no captured graph")
        row = {"bucket": b, "n_real": graph.n}
        for name, fn in (("graphed", graphed), ("unpadded", unpadded),
                         ("eager_padded", eager_padded)):
            row[f"{name}_host_ms"], row[f"{name}_device_ms"] = \
                _per_call_ms(torch, fn)
        with torch.no_grad():
            row["replay_ms"] = _time_ms(torch, fwd.graph.replay)
            row["eager_forward_ms"] = _time_ms(torch, lambda: gnn.apply(
                fwd.params, kcfg, fwd.feats, fwd.lat, node_mask=fwd.node_mask))
        row["host_speedup_vs_eager_padded"] = (row["eager_padded_host_ms"]
                                              / row["graphed_host_ms"])
        emit("gnn_graphs", card=card, **row)
        out[b] = row
    return out


def _shares(row: dict) -> dict:
    """A times row with bound_share = bound / kernel time and vs_library =
    kernel time / library time."""
    return {**row, "bound_share": row["bound_ms"] / row["ms"],
            "vs_library": row["ms"] / row["library_ms"]}


# -- serving gemma3-1b --------------------------------------------------------
SERVE = dict(arch="gemma3-1b", batch=4, prompt=1024, gen=64, seed=0)
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:71",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:58"}


def phase_attention_check(torch, FK, FR, DK, DR) -> dict:
    """Both attention kernels against their plain versions on the sweep of
    ``tests/test_torch_attention_gpu.py``: the reference's FLASH_CASES and
    DEC_CASES and gemma3-1b's own prefill and decode shapes, fp32 and bf16."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_attention_gpu as AG
    import numpy as np
    rng = np.random.default_rng(0)
    normal = lambda shape, dt: AG.normal(rng, shape, dt)
    errs = {"flash_attention": {}, "decode_attention": {}}
    cases = [("flash_attention", c) for c in AG.FLASH_CASES] \
        + [("decode_attention", c) for c in AG.DEC_CASES]
    for name, case in cases:
        if name == "flash_attention":
            b, s, h, kv, d, window, dt = case
            q = normal((b, s, h, d), dt)
            k, v = normal((b, s, kv, d), dt), normal((b, s, kv, d), dt)
            got = FK.flash_attention(q, k, v, window=window)
            want = FR.attention_ref(q, k, v, window=window)
        else:
            b, t, h, kv, d, mask, dt = case
            q = normal((b, 1, h, d), dt)
            k, v = normal((b, t, kv, d), dt), normal((b, t, kv, d), dt)
            valid = torch.from_numpy(AG.dec_mask(t, mask)).cuda()
            got = DK.decode_attention(q, k, v, valid)
            want = DR.decode_attention_ref(q, k, v, valid)
        torch.cuda.synchronize()
        tol = TOL[dt]
        ok, err = _close(torch, got, want, tol)
        emit("kernel_check", kernel=name, case=list(case), dtype=dt,
             max_abs_err=err, max_abs_ref=want.float().abs().max().item(),
             rtol=tol, atol=tol, ok=ok)
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} gave non-finite values at {case}")
        check(ok, f"{name} disagrees with its plain version at {case}: "
                  f"max abs err {err}")
        errs[name][dt] = max(errs[name].get(dt, 0.0), err)
    return errs


# -- every head dim up to 256 ---------------------------------------------------
# the kernels one call of each wrapper may launch, by dtype: anything else in
# a profile of the call (a pad, a copy, a fill) fails the phase
CALL_KERNELS = {
    ("forward", "float32"): ("flash_fwd_kernel",),
    ("forward", "bfloat16"): ("flash_tc_kernel",),
    ("backward", "float32"): ("delta_kernel", "dkv_f32_kernel", "dq_f32_kernel"),
    ("backward", "bfloat16"): ("bwd_prep_kernel", "bwd_wgmma_kernel",
                               "dkv_reduce_kernel"),
    ("decode", "float32"): ("decode_kernel",),
    ("decode", "bfloat16"): ("decode_kernel",)}


def _calls_profile(torch, fns):
    """For each of ``fns``, the device activities (kernels, copies, fills)
    that one call ran, name -> summed device ms: every call (after an
    unprofiled one) under one torch.profiler session (one session per
    call lost all its records after some tens of sessions on the card),
    each inside a ``record_function`` range of its own. The profiler ties
    the launches made inside a range to it by correlation id and records
    the range's device-side span (a ``gpu_user_annotation`` event named
    after it) from the first to the last of them; the activities that
    start inside a call's span are the call's. (Host ops link only the
    kernels of aten ops, not the port's own ctypes launches.) A primer (a
    sleep kernel, waited for) runs before the first call, as a session can
    miss its first kernel on the card. Returns (calls, None), or (None,
    the reason) when a call has no span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    names = [f"chip_smoke.call.{i}" for i in range(len(fns))]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)   # the primer
        torch.cuda.synchronize()
        for name, fn in zip(names, fns):
            with record_function(name):
                fn()
        torch.cuda.synchronize()
    index = {name: i for i, name in enumerate(names)}
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {}
    for e in device:
        if e.is_user_annotation and e.name in index:
            lo, hi = spans.get(index[e.name], (e.time_range.start, e.time_range.end))
            spans[index[e.name]] = (min(lo, e.time_range.start), max(hi, e.time_range.end))
    if len(spans) < len(fns):
        return None, (f"the profile holds device spans for {len(spans)} of "
                      f"{len(fns)} calls ({len(device)} device activities)")
    calls = [{} for _ in fns]
    for e in device:
        i = None if e.is_user_annotation else next(
            (i for i, (lo, hi) in spans.items() if lo <= e.time_range.start <= hi), None)
        if i is not None:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            calls[i][e.name] = calls[i].get(e.name, 0.0) + ms
    return calls, None


def _calls_kernels(torch, fns) -> list:
    """For each of ``fns``, the sorted names of the device activities that
    one call ran (``_calls_profile``); fails when a call has no device span."""
    calls, note = _calls_profile(torch, fns)
    check(calls is not None, f"profiled calls: {note}")
    return [sorted(c) for c in calls]


def phase_head_dims(torch, FK, FR, DK, DR) -> dict:
    """Every head dim of ``tests/test_torch_head_dims_gpu.py`` (8, 36, 40,
    80, 96, 112, 192, 200, 256: each run at the smallest kernel width that
    holds it, read unpadded) in fp32 and bf16 at B 2, S = T = 256, GQA
    group 2: the flash forward causal and with window 64, the backward
    through ``ops.FlashAttention`` (both masks), decode against a
    ring-stale cache; each against its plain version at 2e-5 / 2e-2 with
    launches > 0. One call of each kernel wrapper per (D, dtype), all under
    one torch.profiler session, must run only that kernel's own launches
    (``CALL_KERNELS``): no pad or copy. The one padded call is the bf16
    backward at D % 8 != 0 (its TMA rows need the 16-byte grid), which may
    add its pad and slice kernels. Then ``force_ref=True`` on CUDA tensors
    (flash with and without grad, decode, spmm, scaled_spmm) must launch
    nothing and give the plain version's bits."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_head_dims_gpu as HD
    errs, launches, profiles, calls = {}, {}, {}, []
    for d in HD.HEAD_DIMS:
        for dt in HD.DTYPES:
            tol = TOL[dt]
            runs = [(f"forward window={w}", lambda w=w: HD.forward_case(d, dt, w))
                    for w in HD.WINDOWS]
            runs += [(f"backward window={w}", lambda w=w: HD.backward_case(d, dt, w))
                     for w in HD.WINDOWS]
            runs += [("decode", lambda: HD.decode_case(d, dt))]
            for label, run in runs:
                FK.reset_launches()
                DK.reset_launches()
                got, want = run()
                torch.cuda.synchronize()
                n = {**FK.LAUNCHES, **DK.LAUNCHES}
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err, ok = 0.0, True
                for g, w in zip(got, want):
                    ok_g, err_g = _close(torch, g, w, tol)
                    ok = ok and ok_g and bool(torch.isfinite(g.float()).all())
                    err = max(err, err_g)
                kind = label.split()[0]
                want_n = {"forward": {"flash_attention": 1},
                          "backward": {"flash_attention": 1,
                                       "flash_attention_bwd": 1},
                          "decode": {"decode_attention": 1}}[kind]
                check(all(n[k] == v for k, v in want_n.items()),
                      f"head_dims: {label} at D {d} {dt} launched {n}, want {want_n}")
                check(ok, f"head_dims: {label} at D {d} {dt} differs from its "
                          f"plain version: max abs err {err} (tol {tol})")
                errs.setdefault(kind, {}).setdefault(dt, 0.0)
                errs[kind][dt] = max(errs[kind][dt], err)
                launches[kind] = launches.get(kind, 0) + sum(want_n.values())
                emit("head_dims_check", D=d, dtype=dt, call=label, max_abs_err=err,
                     rtol=tol, atol=tol, ok=ok, launches=n)
            # one call of each wrapper, profiled below
            q, k, v, do = HD.inputs(d, dt, seed=5)
            o, lse = FK.flash_attention(q, k, v, return_lse=True)
            q1, valid = q[:, :1].contiguous(), HD.ring_valid(HD.S)
            calls += [
                ("forward", d, dt, lambda q=q, k=k, v=v: FK.flash_attention(q, k, v)),
                ("backward", d, dt, lambda q=q, k=k, v=v, o=o, lse=lse, do=do:
                    FK.flash_attention_bwd(q, k, v, o, lse, do)),
                ("decode", d, dt, lambda q1=q1, k=k, v=v, valid=valid:
                    DK.decode_attention(q1, k, v, valid))]
    for (kind, d, dt, _), names in zip(calls, _calls_kernels(
            torch, [c[3] for c in calls])):
        own = CALL_KERNELS[(kind, dt)]
        other = [x for x in names if not any(n in x for n in own)]
        unpadded = not (kind == "backward" and dt == "bfloat16" and d % 8)
        profiles[f"{kind} D {d} {dt}"] = {"kernels": names,
                                         "read_unpadded": unpadded}
        check(any(any(n in x for n in own) for x in names),
              f"head_dims: a profiled {kind} call at D {d} {dt} ran none of "
              f"its kernels: {names}")
        if unpadded:
            check(not other, f"head_dims: a {kind} call at D {d} {dt} ran "
                             f"more than its kernels: {other}")
    del calls
    # force_ref on CUDA: nothing launched, the plain version's bits
    force = {}
    for dt in HD.DTYPES:
        for name, call, plain in HD.force_ref_calls(dt):
            before = HD.launch_counts()
            got = call()
            torch.cuda.synchronize()
            same = HD.launch_counts() == before
            equal = got.is_cuda and bool(torch.equal(got, plain()))
            force[f"{name} {dt}"] = {"launched_nothing": same, "bit_equal": equal}
            check(same and equal, f"head_dims: force_ref {name} {dt} on CUDA "
                                  f"launched {same=} or differs {equal=}")
    emit("head_dims", head_dims=list(HD.HEAD_DIMS), shape=dict(
        B=HD.B, S=HD.S, T=HD.S, H=HD.H, KV=HD.KV), max_abs_err=errs,
        launches=launches, profiles=profiles, force_ref=force)
    return errs


# -- every input the reference's kernels take -----------------------------------
# the kernels of one call per body (``FK.dispatch``'s "body"; decode has one)
BODY_KERNELS = {"fma_fwd": ("flash_fwd_kernel",), "mma": ("flash_tc_kernel",),
                "fma": ("delta_kernel", "dkv_f32_kernel", "dq_f32_kernel"),
                "wgmma": ("bwd_prep_kernel", "bwd_wgmma_kernel", "dkv_reduce_kernel"),
                "cluster": ("decode_kernel",)}
PROFILED_D = 320


def phase_kernel_domain(torch, FK, FR, DK, DR) -> dict:
    """Every case of ``tests/test_torch_kernel_domain_gpu.py`` against the
    plain versions (2e-5 fp32, 2e-2 bf16, 1e-2 fp16), each with launches >
    0: head dims 257-1024 (column passes of 256) in fp32, bf16 and fp16 on
    the flash forward (causal and window 64), its backward through
    ``ops.FlashAttention`` and decode; fp16 at D 36, 96 and 256 and on
    ``gcn_spmm`` at buckets 64 and 1024; a transposed, a column-sliced, an
    unbound and a 2-byte-offset view on every kernel, bit for bit the dense
    call, each copied or not as ``view_copies`` says (the attention kernels
    read all but the offset one through their strides); an fp32
    adjacency with bf16 features; query rows that see no key (S 12, T 6,
    window 2, causal and not, forward and backward). The 2-byte backward's
    wide body also on no-key rows at D 320, at GQA group 4 and D 512 (with
    and without a window) and on the four views at D 512, bit for bit the
    dense call. Then one call of each
    wrapper at D 320 per dtype on dense, aligned inputs and one on
    head-transposed views of them, all under one profiler session, must run
    only its body's own kernels: no copy."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_kernel_domain_gpu as KD
    from repro_torch.kernels.gcn_spmm import kernel as K
    errs, launches, n_cases = {}, {}, 0

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    def run(label, kind, dt, fn, want_names):
        nonlocal n_cases
        FK.reset_launches()
        DK.reset_launches()
        K.reset_launches()
        got, want = fn()
        torch.cuda.synchronize()
        n = {**FK.LAUNCHES, **DK.LAUNCHES, **K.LAUNCHES}
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        tol = TOL[dt]
        err, ok = 0.0, True
        for g, w in zip(got, want):
            ok_g, err_g = _close(torch, g, w, tol)
            ok = ok and ok_g and bool(torch.isfinite(g.float()).all()) \
                and g.dtype == w.dtype and g.shape == w.shape
            err = max(err, err_g)
        check(all(n[k] > 0 for k in want_names),
              f"kernel_domain: {label} launched {n}, want {want_names} > 0")
        check(ok, f"kernel_domain: {label} differs from its plain version: "
                  f"max abs err {err} (tol {tol})")
        errs.setdefault(kind, {}).setdefault(dt, 0.0)
        errs[kind][dt] = max(errs[kind][dt], err)
        add(n)
        n_cases += 1
        emit("kernel_domain_check", call=label, dtype=dt, max_abs_err=err,
             rtol=tol, atol=tol, ok=ok, launches={k: v for k, v in n.items() if v})

    flash, bwd = ["flash_attention"], ["flash_attention", "flash_attention_bwd"]
    for d, dt in KD.DIM_DTYPES:
        for w in KD.WINDOWS:
            run(f"forward D {d} window={w}", "forward", dt,
                lambda: KD.forward_case(d, dt, w), flash)
            run(f"backward D {d} window={w}", "backward", dt,
                lambda: KD.backward_case(d, dt, w), bwd)
        run(f"decode D {d}", "decode", dt, lambda: KD.decode_case(d, dt),
            ["decode_attention"])
    for n in KD.SPMM_BUCKETS:
        for scaled in (False, True):
            name = "scaled_spmm" if scaled else "spmm"
            run(f"{name} bucket {n}", name, "float16",
                lambda: KD.spmm_case(n, "float16", scaled), [name])
            run(f"{name} bucket {n} fp32 adj", name, "bfloat16",
                lambda: KD.spmm_case(n, "bfloat16", scaled, adj_dtype="float32"),
                [name])
    for dt in KD.DTYPES:
        for causal in (True, False):
            for backward in (False, True):
                run(f"no-key rows causal={causal} "
                    f"{'backward' if backward else 'forward'}", "no_key", dt,
                    lambda: KD.nokey_case(dt, causal, backward),
                    bwd if backward else flash)
    # the 2-byte backward's wide body: no-key rows at D 320, GQA group 4 at
    # D 512 (gemma3-1b's H 4, KV 1) with and without a window
    for dt in KD.DTYPES[1:]:
        for causal in (True, False):
            run(f"no-key rows causal={causal} backward D {KD.NOKEY_WIDE_D}", "no_key",
                dt, lambda: KD.nokey_case(dt, causal, True, d=KD.NOKEY_WIDE_D), bwd)
    for case in KD.WIDE_SHAPES:
        if case[3:5] == (4, 1):   # group 4
            run(f"backward G 4 D {case[5]} window={case[7]}", "backward", case[8],
                lambda: KD.wide_backward_case(case), bwd)
    # every kernel on each view, and the wide backward on each view at D 512
    # in the types of its body
    views = {}
    for kernel, kind, dt, d in (
            [(kernel, kind, "bfloat16", None)
             for kernel in KD.VIEW_KERNELS for kind in KD.VIEWS]
            + [("flash_attention_bwd", kind, dt, KD.WIDE_VIEW_D)
               for dt in KD.DTYPES[1:] for kind in KD.VIEWS]):
        before = KD.launch_counts()
        got, want, odd, copied = KD.view_case(kernel, kind, dt, d=d)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        n = {k: c - before[k] for k, c in KD.launch_counts().items()}
        label = f"{kernel} {kind}" + ("" if d is None else f" D {d} {dt}")
        views[label] = {"bit_equal": equal, "launches": n[kernel], "copied": copied}
        check(odd and equal and n[kernel] > 0
              and copied == KD.view_copies(kernel, kind),
              f"kernel_domain: {kernel} on a {kind} view ({label}): {odd=} {equal=} "
              f"{copied=} launches {n}")
        add(n)
    # one call of each wrapper per dtype at D 320 on dense, aligned inputs
    # and on head-transposed views of them (read through their strides)
    calls = []
    for dt in KD.DTYPES:
        dense = KD.inputs(PROFILED_D, dt, seed=7)
        for layout in ("dense", "strided"):
            q, k, v, do = dense if layout == "dense" else \
                (KD.view_of(x, "transposed") for x in dense)
            o, lse = FK.flash_attention(q, k, v, return_lse=True)
            q1, valid = q[:, :1], KD.ring_valid(k.shape[1])
            fwd_plan = FK.dispatch(PROFILED_D, q.dtype, (q, k, v))
            bwd_plan = FK.dispatch(PROFILED_D, q.dtype, (q, k, v, o, do), backward=True)
            dec_plan = DK.dispatch(PROFILED_D, (q1, k, v, valid))
            check(not any(fwd_plan["copy"] + bwd_plan["copy"] + dec_plan["copy"]),
                  f"kernel_domain: {layout} D {PROFILED_D} {dt} inputs would be copied")
            fwd_body = "fma_fwd" if fwd_plan["body"] == "fma" else fwd_plan["body"]
            calls += [
                ("forward", layout, dt, fwd_body,
                 lambda q=q, k=k, v=v: FK.flash_attention(q, k, v)),
                ("backward", layout, dt, bwd_plan["body"],
                 lambda q=q, k=k, v=v, o=o, lse=lse, do=do:
                    FK.flash_attention_bwd(q, k, v, o, lse, do)),
                ("decode", layout, dt, "cluster", lambda q1=q1, k=k, v=v, valid=valid:
                    DK.decode_attention(q1, k, v, valid))]
    profiles = {}
    for (kind, layout, dt, body, _), names in zip(calls, _calls_kernels(
            torch, [c[4] for c in calls])):
        own = BODY_KERNELS[body]
        other = [x for x in names if not any(n in x for n in own)]
        profiles[f"{kind} D {PROFILED_D} {dt} {layout}"] = {"body": body, "kernels": names}
        check(names and not other,
              f"kernel_domain: a {kind} call at D {PROFILED_D} {dt} on {layout} inputs "
              f"ran more than its kernels {own}: {names}")
    del calls
    emit("kernel_domain", wide_dims=list(KD.WIDE_DIMS), f16_dims=list(KD.F16_DIMS),
         shape=dict(B=KD.B, S=KD.S, H=KD.H, KV=KD.KV), cases=n_cases,
         max_abs_err=errs, views=views, profiles=profiles, launches=launches)
    return {"errs": errs, "launches": launches}


def _dev_time(e) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def _first_decode_pos(cfg, inputs) -> int:
    """The first generated token's position: after the prompt, and after a
    VLM's patches."""
    return (cfg.n_patches if cfg.family == "vlm" else 0) \
        + inputs["tokens"].shape[1]


def _profile_prefill(torch, params, cfg, inputs, max_len, repeats=5) -> dict:
    """Median host wall time of ``repeats`` warm prefills (each ended by a
    synchronize; ``make_prefill``'s step over ``inputs``: the tokens and a
    family's frames or patches), then one prefill under torch.profiler
    (CUDA activity): the device time of its kernels, the flash kernel's
    part of it and the largest kernels. Tokens/s counts the prompt's
    tokens, as ``serve_batch`` does."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.train_step import make_prefill
    prefill = make_prefill(cfg)
    walls = []
    with torch.no_grad():
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, inputs, max_len)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(params, inputs, max_len)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_dev_time(e) for e in kernels)
    flash_us = sum(_dev_time(e) for e in kernels if "flash_" in e.key)
    top = sorted(kernels, key=_dev_time, reverse=True)[:6]
    wall = statistics.median(walls)
    return {"repeats": repeats, "wall_ms_median": wall * 1e3,
            "wall_ms": [w * 1e3 for w in walls],
            "tokens_per_s_median": inputs["tokens"].numel() / wall,
            "device_busy_ms": busy_us / 1e3, "flash_ms": flash_us / 1e3,
            "flash_share_of_busy": flash_us / busy_us,
            "top_kernels": [[e.key[:100], _dev_time(e) / 1e3, e.count]
                            for e in top]}


def _profile_decode(torch, dlm, params, cfg, tokens, fed, max_len, steps=3):
    """The eager decode step (``decode_step`` with an int pos, op by op, as
    before the graph): host wall time per step over ``steps`` unprofiled
    steps, then device busy share and the top device ops over ``steps``
    steps under torch.profiler (CUDA activity), each run after a fresh
    prefill."""
    from torch.profiler import ProfilerActivity, profile
    s = tokens.shape[1]
    with torch.no_grad():
        _, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            _, caches = dlm.decode_step(params, cfg, fed[:, i:i + 1], s + i, caches)
        torch.cuda.synchronize()
        unprofiled = (time.perf_counter() - t0) / steps
        _, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                _, caches = dlm.decode_step(params, cfg, fed[:, i:i + 1], s + i,
                                            caches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel events only: an operator's device time repeats its kernels'
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_dev_time(e) for e in kernels)
    top = sorted(kernels, key=_dev_time, reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "unprofiled_ms_per_step": unprofiled * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_idle_share_unprofiled":
                1.0 - busy_us / 1e3 / steps / (unprofiled * 1e3),
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "cpu_events_per_step": sum(e.count for e in events
                                       if e not in kernels) / steps,
            "top_kernels": [[e.key[:100], _dev_time(e) / steps, e.count / steps]
                            for e in top]}


def _graph_vs_eager(torch, serve, params, cfg, inputs, fed, gen, max_len,
                    steps=8) -> dict:
    """The captured step against the eager one on the same weights and the
    same prefill caches (``make_prefill``'s step over ``inputs``): the
    family's ``decode_step`` captured with a tensor pos and replayed
    teacher-forced on ``fed`` against eager ``decode_step`` calls (logits,
    bit for bit expected: the same kernels in the same order), and
    ``serve_batch``'s graphed tokens ``gen`` against an eager greedy loop
    of ``make_decode_step``'s step."""
    from repro_torch._tree import tree_map
    from repro_torch.models.registry import get_api
    from repro_torch.training.train_step import make_decode_step, make_prefill
    api = get_api(cfg)
    prefill = make_prefill(cfg, api)
    s = _first_decode_pos(cfg, inputs)
    clone = lambda tree: tree_map(torch.clone, tree)

    with torch.no_grad():
        last, caches = prefill(params, inputs, max_len)
        eager_caches = clone(caches)
        tok = fed[:, :1].clone()
        pos = torch.full((), s, dtype=torch.int32, device=fed.device)
        api.decode_step(params, cfg, tok, pos, clone(caches))   # eager warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = api.decode_step(params, cfg, tok, pos, caches)
        errs, same = [], True
        for i in range(steps):
            tok.copy_(fed[:, i:i + 1])
            pos.fill_(s + i)
            graph.replay()
            want, eager_caches = api.decode_step(params, cfg, fed[:, i:i + 1],
                                                 s + i, eager_caches)
            torch.cuda.synchronize()
            same = same and torch.equal(logits, want)
            errs.append((logits - want).abs().max().item())
        graph.reset()
        del graph, logits, caches, eager_caches
        step = make_decode_step(cfg, api)
        _, caches = prefill(params, inputs, max_len)
        t = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [t]
        for i in range(gen.shape[1] - 1):
            t, caches = step(params, t, s + i, caches)
            out.append(t)
        eager_gen = torch.cat(out, dim=1).cpu().numpy()
    return {"steps": steps, "logits_bit_identical": same,
            "logits_max_abs_err": max(errs),
            "tokens_equal": bool((eager_gen == gen).all()),
            "token_agreement": float((eager_gen == gen).mean())}


def _profile_decode_graph(torch, serve, params, cfg, inputs, max_len, DK,
                          steps=16) -> dict:
    """Replays of ``serve_batch``'s captured decode step under torch.profiler
    (CUDA activity), after a fresh prefill: host wall time per step (an
    unprofiled run of the same replays first), device-busy time per step,
    the device's idle share, kernels per step, the decode kernel's launches
    per step and the top kernels. The graph is captured while the profiler
    records, so its kernels are traced. A sleep kernel queued just before
    the replays marks their start on the card's own clock: only device
    activity after it is counted (the host's and the card's timestamps may
    be offset by more than a kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.train_step import make_decode_step, make_prefill
    s = _first_decode_pos(cfg, inputs)
    step = make_decode_step(cfg)
    prefill = make_prefill(cfg)

    def prefilled():
        last, caches = prefill(params, inputs, max_len)
        return torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None], caches

    with torch.no_grad():
        tok, caches = prefilled()
        graph = serve.DecodeGraph(step, params, tok, s, caches, steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            graph.replay()
        torch.cuda.synchronize()
        wall_unprofiled = (time.perf_counter() - t0) / steps
        graph.release()
        del graph
        tok, caches = prefilled()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph = serve.DecodeGraph(step, params, tok, s, caches, steps)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)   # the marker
            t0 = time.perf_counter()
            for _ in range(steps):
                graph.replay()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        graph.release()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    marks = [e for e in device if "spin_kernel" in e.name or "sleep" in e.name]
    check(len(marks) == 1, f"the profiler shows {len(marks)} replay markers")
    lo = marks[0].time_range.end
    # device activity (kernels, copies, fills) after the marker
    kernels = [e for e in device if e.time_range.start >= lo and e is not marks[0]]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    dec = sum(n for name, (n, _) in by_name.items() if "decode_kernel" in name)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3,
            "unprofiled_ms_per_step": wall_unprofiled * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / (wall * steps),
            "device_idle_share_unprofiled":
                1.0 - busy_us / 1e6 / (wall_unprofiled * steps),
            "kernels_per_step": len(kernels) / steps,
            "decode_kernels_per_step": dec / steps,
            "top_kernels": [[name[:100], t / 1e3 / steps, n / steps]
                            for name, (n, t) in top]}


def phase_serve(torch, device, FK, DK) -> dict:
    """gemma3-1b at full width, bf16, random weights from a seeded generator,
    through the port's ``serve_batch`` (which turns ``use_flash`` on and
    decodes by graph replays), after one short warm-up call, then once more
    to show that the graph's memory is released. The graphed step is held
    against the eager one (tokens equal, logits bit for bit or within 2e-2),
    and both decode loops are profiled. Then the same weights teacher-forced on the
    generated tokens, with ``use_flash`` on and off, in bf16 and upcast to
    fp32. In fp32 the kernel path must give the plain path's logits within
    the model-level tolerance: the same function. In bf16 the two paths
    round at different places (the plain einsums round scores and softmax
    weights to bf16, the kernels keep them in fp32), so over 26 layers their
    logits differ by more than 2e-2; those differences, each path's
    distance from the fp32 logits and the greedy agreement are printed, not
    asserted."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.models import common as cc
    from repro_torch.models import decoder_lm as dlm

    cfg = get_config(SERVE["arch"])
    b, s, gen_n = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    max_len = s + gen_n
    t0 = time.perf_counter()
    params = dlm.init_params(cfg, seed=SERVE["seed"], device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=SERVE["seed"]), 0)
    run = _serve_twice(torch, serve, cfg, params, batch, gen_n, FK, DK)
    _record_served(torch, cfg, params, batch, gen_n, run)
    gen, stats, launches = run["gen"], run["stats"], run["launches"]
    n_layers = cfg.n_layers
    # one eager warm-up step before the capture, then gen_n - 1 replays of a
    # graph that holds one step: n_layers decode launches per step, gen_n
    # steps' worth; the capture itself launches nothing
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * gen_n},
          f"serve launches {launches}, want {n_layers} flash and "
          f"{n_layers * gen_n} decode")
    tokens = torch.as_tensor(batch["tokens"], device=device)
    fed = torch.as_tensor(gen, device=device)
    g_vs_e = _graph_vs_eager(torch, serve, params, cfg, {"tokens": tokens},
                             fed, gen, max_len)
    emit("serve_graph_vs_eager", **g_vs_e)
    check(g_vs_e["tokens_equal"], "graphed serve tokens differ from the eager "
                                  "greedy loop's")
    check(g_vs_e["logits_bit_identical"] or g_vs_e["logits_max_abs_err"] <= 2e-2,
          f"graphed decode logits differ from eager ones by "
          f"{g_vs_e['logits_max_abs_err']}")
    prof = _profile_decode(torch, dlm, params, cfg, tokens, fed, max_len)
    gprof = _profile_decode_graph(torch, serve, params, cfg, {"tokens": tokens},
                                  max_len, DK)
    emit("serve_prefill_profile",
         **_profile_prefill(torch, params, cfg, {"tokens": tokens}, max_len))

    def teacher_forced(p, c, flash: bool):
        cc.RUNTIME["use_flash"] = flash
        with torch.no_grad():
            last, caches = dlm.prefill(p, c, tokens=tokens, max_len=max_len)
            logits = [last[:, -1]]
            for i in range(gen_n - 1):
                step, caches = dlm.decode_step(p, c, fed[:, i:i + 1], s + i,
                                               caches)
                logits.append(step[:, -1])
        return torch.stack(logits, dim=1)            # (B, gen, V) fp32

    on = teacher_forced(params, cfg, True)
    off = teacher_forced(params, cfg, False)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    on32 = teacher_forced(params32, cfg32, True)
    off32 = teacher_forced(params32, cfg32, False)
    del params32
    cc.RUNTIME["use_flash"] = True
    check(all(bool(torch.isfinite(x).all()) for x in (on, off, on32, off32)),
          "serve logits are not finite")
    tol32 = 2e-4      # tests/test_kernels.py: the model-level fp32 tolerance
    ok32_prefill, err32_prefill = _close(torch, on32[:, 0], off32[:, 0], tol32)
    ok32_decode, err32_decode = _close(torch, on32[:, 1:], off32[:, 1:], tol32)
    rms = lambda x: x.square().mean().sqrt().item()
    rms_kernel = rms(on - off32)
    rms_plain = rms(off - off32)
    emit("serve", arch=SERVE["arch"], dtype=cfg.dtype, layers=n_layers,
         d_model=cfg.d_model, params=dlm.param_count(params), init_s=t_init,
         batch=b, prompt_tokens=s, gen_tokens=gen_n, max_len=max_len,
         prefill_tokens_per_s=stats["prefill_tokens_per_s"],
         decode_tokens_per_s=stats["tokens_per_s"], prefill_s=stats["prefill_s"],
         decode_s=stats["decode_s"], cold_prefill_s=run["cold"]["prefill_s"],
         decode_capture_s=stats["decode_capture_s"],
         repeat_call=run["repeat_call"], peak_mem_bytes=run["peak_mem_bytes"],
         peak_mem_bytes_repeat_call=run["peak_mem_bytes_repeat_call"],
         allocated_bytes_after_calls=run["allocated"], launches=launches,
         fp32_prefill_logits_max_abs_err_kernels_vs_plain=err32_prefill,
         fp32_decode_logits_max_abs_err_kernels_vs_plain=err32_decode,
         fp32_tol=tol32,
         bf16_logits_rms_err_vs_fp32={"kernels": rms_kernel, "plain": rms_plain},
         bf16_prefill_logits_max_abs_err_kernels_vs_plain=(
             on[:, 0] - off[:, 0]).abs().max().item(),
         bf16_decode_logits_max_abs_err_kernels_vs_plain=(
             on[:, 1:] - off[:, 1:]).abs().max().item(),
         logits_max_abs=off.abs().max().item(),
         greedy_agreement_with_plain=(off.argmax(-1) == fed).float().mean().item(),
         greedy_agreement_with_fp32=(off32.argmax(-1) == fed).float().mean().item(),
         replay_matches_serve=(on.argmax(-1) == fed).float().mean().item(),
         sample=gen[0, :8].tolist())
    emit("serve_profile", **prof)
    emit("serve_decode_graph_profile", **gprof)
    check(gprof["decode_kernels_per_step"] == n_layers,
          f"a profiled replay ran {gprof['decode_kernels_per_step']} decode "
          f"kernels per step, want {n_layers}")
    check(ok32_prefill, f"fp32 prefill logits with the kernels differ from "
                        f"the plain path by {err32_prefill}")
    check(ok32_decode, f"fp32 teacher-forced decode logits with the kernels "
                       f"differ from the plain path by {err32_decode}")
    return launches


# -- the MoE, MLA, Mamba and xLSTM families -----------------------------------
OLMOE = dict(arch="olmoe-1b-7b", batch=4, prompt=1024, gen=64, seed=0)
DEEPSEEK = dict(arch="deepseek-v2-236b", batch=4, prompt=512, gen=32, seed=0)
# A token whose expert choices differ between two runs is a near tie when
# its router margin (the least gap between neighbours among its k + 1
# largest probabilities) is below NEAR_TIE in either run: fp32 noise of
# ~1e-6 in the router logits moves a probability by ~1e-8. A flip above it,
# at a token no earlier flip reached, fails.
NEAR_TIE = 1e-5
# A flip changes its token's expert, a capacity drop elsewhere in the group,
# and through attention the rest of the sequences it reaches, so their later
# logits rows are left out of the fp32 comparison; more than this share of
# rows left out fails. The prefill routes its 4 sequences in order, so the
# drops, and a flip's shifted slots, fall on the later ones.
MAX_FLIPPED_ROWS = 0.5
TOL32 = 2e-4      # tests/test_kernels.py: the model-level fp32 tolerance


def _moe_layers(cfg) -> int:
    return sum(seg.count * sum(l.mlp == "moe" for l in seg.layers)
               for seg in cfg.segments)


def _teacher_forced(torch, dlm, mlp, cc, params, cfg, tokens, fed, max_len,
                    flash: bool):
    """The prompt's logits at every position (``forward``), then a prefill
    and fed.shape[1] - 1 eager decode steps fed ``fed`` with the routing
    recorded: (logits (B, S + gen - 1, V) fp32, row j at position j; the
    routing records; each record's first position)."""
    s = tokens.shape[1]
    cc.RUNTIME["use_flash"] = flash
    with torch.no_grad():
        logits = [dlm.forward(params, cfg, tokens=tokens)[0].float()]
        with mlp.record_routing() as rec:
            _, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
            for i in range(fed.shape[1] - 1):
                step, caches = dlm.decode_step(params, cfg, fed[:, i:i + 1],
                                               s + i, caches)
                logits.append(step.float())
    cc.RUNTIME["use_flash"] = True
    n_moe = _moe_layers(cfg)
    offsets = [0] * n_moe + [s + i for i in range(fed.shape[1] - 1)
                             for _ in range(n_moe)]
    return torch.cat(logits, dim=1), list(rec), offsets


def _routing_flips(torch, rec_a, rec_b, offsets, n_moe: int) -> dict:
    """Two runs' routing records compared call by call, in the order the
    layers ran (``record_routing``: (gate_idx (B,S,k), keep (B,S,k), margin
    (B,S)) per MoE call; ``offsets``: each call's first position). A token
    whose expert choices differ is a near tie (margin below NEAR_TIE in
    either run), downstream (an earlier call's flip already reached its
    position in its sequence) or real. Any difference, a capacity drop
    included, reaches its sequence from that position on. Returns the
    flipped choices per MoE layer, the three counts, and per sequence the
    first position reached."""
    per_layer = [0] * n_moe
    near = downstream = real = 0
    first = torch.full((rec_a[0][0].shape[0],), 1 << 30, dtype=torch.long,
                       device=rec_a[0][0].device)
    for i, ((ia, ka, ma), (ib, kb, mb), off) in enumerate(
            zip(rec_a, rec_b, offsets)):
        idx_diff = (ia != ib).any(-1)                        # (B, S)
        per_layer[i % n_moe] += int((ia != ib).sum() + (ka != kb).sum())
        tie = torch.minimum(ma, mb) < NEAR_TIE
        pos = off + torch.arange(ia.shape[1], device=ia.device)
        reached = pos[None, :] >= first[:, None]
        near += int((idx_diff & tie).sum())
        downstream += int((idx_diff & ~tie & reached).sum())
        real += int((idx_diff & ~tie & ~reached).sum())
        hit = idx_diff | (ka != kb).any(-1)
        first = torch.minimum(first, torch.where(hit, pos[None, :], 1 << 30)
                              .amin(dim=1))
    return {"calls": len(rec_a), "flipped_choices_per_layer": per_layer,
            "near_tie_flipped_tokens": near,
            "downstream_flipped_tokens": downstream,
            "real_flipped_tokens": real,
            "first_position_reached": {b: int(f) for b, f in
                                       enumerate(first.tolist())
                                       if f < 1 << 30}}


def _compare_routed(torch, logits_a, logits_b, flips) -> dict:
    """The logits rows (b, j), at position j, that no routing difference
    reached, compared at TOL32."""
    b, rows = logits_a.shape[:2]
    pos = torch.arange(rows, device=logits_a.device)
    first = torch.tensor([flips["first_position_reached"].get(i, 1 << 30)
                          for i in range(b)], device=logits_a.device)
    clean = pos[None, :] < first[:, None]                    # (B, rows)
    n_clean = int(clean.sum())
    ok, err = _close(torch, logits_a[clean], logits_b[clean], TOL32) \
        if n_clean else (True, 0.0)
    return {"rows": b * rows, "rows_compared": n_clean,
            "flipped_row_share": 1 - n_clean / (b * rows),
            "max_abs_err_compared_rows": err, "ok": ok, "tol": TOL32}


def _serve_twice(torch, serve, cfg, params, batch, gen_n: int, FK, DK) -> dict:
    """A short warm-up call (``cold``), then ``serve_batch`` with the launch
    counts zeroed just before it and read just after, then a repeat call
    that must give the same tokens and hold no more memory: the graph and
    its pool are released. Peak memory is read for each of the two."""
    _, cold = serve.serve_batch(cfg, params, batch, 2, log=lambda *_: None)
    torch.cuda.synchronize()
    allocated = [torch.cuda.memory_allocated()]
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    DK.reset_launches()
    gen, stats = serve.serve_batch(cfg, params, batch, gen_n, log=lambda *_: None)
    launches = {"flash_attention": FK.LAUNCHES["flash_attention"],
                "decode_attention": DK.LAUNCHES["decode_attention"]}
    torch.cuda.synchronize()
    peaks = [torch.cuda.max_memory_allocated()]
    allocated.append(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    gen_again, stats_again = serve.serve_batch(cfg, params, batch, gen_n,
                                               log=lambda *_: None)
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    allocated.append(torch.cuda.memory_allocated())
    check(max(allocated[1:]) <= allocated[0],
          f"{cfg.name}: device memory after serve calls grows: {allocated}")
    check((gen_again == gen).all(), f"{cfg.name}: a repeat serve call "
                                    "generated other tokens")
    check(gen.shape[1] == gen_n and ((gen >= 0) & (gen < cfg.vocab_size)).all(),
          f"{cfg.name}: generated tokens of shape {gen.shape} out of range")
    return {"gen": gen, "stats": stats, "cold": cold, "launches": launches,
            "repeat_call": {k: stats_again[k] for k in (
                "prefill_tokens_per_s", "tokens_per_s", "decode_capture_s")},
            "peak_mem_bytes": peaks[0], "peak_mem_bytes_repeat_call": peaks[1],
            "allocated": allocated}


# What each full-width serve phase held on the card (``_record_served``), and
# the training phase's peak: the pricer and the dry-run are held to them.
HELD: dict = {}


def _tree_bytes(tree) -> int:
    from repro_torch._tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _record_served(torch, cfg, params, batch, gen_n: int, run: dict) -> None:
    """The bytes of the params the serve phase holds on the card, the bytes
    of the caches its prefill makes (one more prefill of the same inputs,
    as ``serve_batch`` runs it), its batch and cache length, its peak
    memory and its decode rate."""
    from repro_torch.models.registry import get_api
    from repro_torch.training.train_step import device_batch, make_prefill
    inputs = device_batch(cfg, {k: v for k, v in batch.items()
                                if k in ("tokens", "frames", "patches")},
                          next(iter(params.values())).device)
    max_len = _first_decode_pos(cfg, inputs) + gen_n
    with torch.no_grad():
        _, caches = make_prefill(cfg, get_api(cfg))(params, inputs, max_len)
    HELD[cfg.name] = {
        "param_bytes": _tree_bytes(params), "cache_bytes": _tree_bytes(caches),
        "batch": inputs["tokens"].shape[0], "prompt": inputs["tokens"].shape[1],
        "gen": gen_n, "max_len": max_len,
        "peak_mem_bytes": run["peak_mem_bytes"],
        "tokens_per_s": run["stats"]["tokens_per_s"]}
    del caches, inputs
    torch.cuda.empty_cache()


def _serve_fields(run: dict) -> dict:
    """The serve metrics of a ``_serve_twice`` run."""
    return {**{k: run["stats"][k] for k in (
        "prefill_tokens_per_s", "tokens_per_s", "prefill_s", "decode_s",
        "decode_capture_s")}, "repeat_call": run["repeat_call"],
        "peak_mem_bytes": run["peak_mem_bytes"],
        "allocated_bytes_after_calls": run["allocated"]}


def phase_serve_olmoe(torch, device, FK, DK) -> dict:
    """olmoe-1b-7b at full width (16 layers, d_model 2048, 16 query and 16
    KV heads of 128, qk-norm, 64 experts top-8, d_ff_expert 1024, vocab
    50,304), bf16, random weights from a seeded generator on the card,
    through ``serve_batch`` (4 prompts of 1024, 64 generated, the decode
    step replayed from one CUDA graph). The prompt equals ``moe_seq_chunk``
    (1024), so the prefill's MoE takes the unchunked path: one group of 4096
    tokens with capacity int(4096 x 8 / 64 x 1.25) = 640. The graphed step
    against the eager one, bit for bit; decode and prefill profiles. Then
    the same weights in fp32, teacher-forced on the served tokens with
    ``use_flash`` on and off and the routing recorded: the decisions are
    compared first, layer by layer, then the logits on the rows that no
    routing flip reached."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.models import common as cc
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.models import mlp

    torch.cuda.empty_cache()
    cfg = get_config(OLMOE["arch"])
    b, s, gen_n = OLMOE["batch"], OLMOE["prompt"], OLMOE["gen"]
    max_len = s + gen_n
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    params = dlm.init_params(cfg, seed=OLMOE["seed"], device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = dlm.param_count(params)
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=OLMOE["seed"]), 0)
    run = _serve_twice(torch, serve, cfg, params, batch, gen_n, FK, DK)
    _record_served(torch, cfg, params, batch, gen_n, run)
    gen, launches = run["gen"], run["launches"]
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * gen_n},
          f"olmoe serve launches {launches}, want {n_layers} flash and "
          f"{n_layers * gen_n} decode")
    tokens = torch.as_tensor(batch["tokens"], device=device)
    fed = torch.as_tensor(gen, device=device)
    g_vs_e = _graph_vs_eager(torch, serve, params, cfg, {"tokens": tokens},
                             fed, gen, max_len)
    emit("serve_olmoe_graph_vs_eager", **g_vs_e)
    check(g_vs_e["tokens_equal"] and g_vs_e["logits_bit_identical"],
          f"olmoe's graphed decode differs from the eager one: {g_vs_e}")
    gprof = _profile_decode_graph(torch, serve, params, cfg, {"tokens": tokens},
                                  max_len, DK)
    emit("serve_olmoe_decode_graph_profile", **gprof)
    check(gprof["decode_kernels_per_step"] == n_layers,
          f"a profiled olmoe replay ran {gprof['decode_kernels_per_step']} "
          f"decode kernels per step, want {n_layers}")
    emit("serve_olmoe_prefill_profile",
         **_profile_prefill(torch, params, cfg, {"tokens": tokens}, max_len))

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    on, rec_on, offsets = _teacher_forced(torch, dlm, mlp, cc, params32, cfg32,
                                          tokens, fed, max_len, True)
    off, rec_off, _ = _teacher_forced(torch, dlm, mlp, cc, params32, cfg32,
                                      tokens, fed, max_len, False)
    del params32
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(on).all() and torch.isfinite(off).all()),
          "olmoe fp32 logits are not finite")
    n_moe = _moe_layers(cfg)
    flips = _routing_flips(torch, rec_on, rec_off, offsets, n_moe)
    cmp32 = _compare_routed(torch, on, off, flips)
    moe = cfg.segments[0].layers[0].moe
    emit("serve_olmoe", arch=OLMOE["arch"], dtype=cfg.dtype, layers=n_layers,
         d_model=cfg.d_model, params=n_params, init_s=t_init, batch=b,
         prompt_tokens=s, gen_tokens=gen_n, max_len=max_len,
         **_serve_fields(run), launches=launches,
         prefill_moe_capacity=max(1, int(b * s * moe.top_k / moe.n_experts
                                         * moe.capacity_factor)),
         prefill_dropped_choices_plain=sum(int((~k).sum())
                                           for _, k, _ in rec_off[:n_moe]),
         routing_fp32_kernels_vs_plain=flips, fp32_logits_kernels_vs_plain=cmp32,
         greedy_agreement_fp32_plain=(off[:, s - 1:].argmax(-1)
                                      == fed).float().mean().item(),
         sample=gen[0, :8].tolist())
    check(flips["real_flipped_tokens"] == 0,
          f"olmoe's routing differs between the kernel and plain paths away "
          f"from a near tie: {flips}")
    check(cmp32["flipped_row_share"] <= MAX_FLIPPED_ROWS,
          f"routing flips reach {cmp32['flipped_row_share']:.2f} of the olmoe "
          f"logits rows (at most {MAX_FLIPPED_ROWS})")
    check(cmp32["ok"], f"fp32 olmoe logits with the kernels differ from the "
                       f"plain path on rows of identical routing: {cmp32}")
    return launches


def phase_serve_deepseek_v2(torch, device, FK, DK) -> None:
    """deepseek-v2-236b at full widths (d_model 5120, MLA with 128 heads, q
    and kv LoRA ranks 1536 / 512, vocab 102,400; 160 experts top-6 of width
    1536 with 2 shared) cut in depth from 60 layers to 2: the dense layer 0
    (d_ff 12,288) and one MoE layer. bf16, random weights: ``serve_batch``
    (4 prompts of 512, 32 generated, graphed decode) in the plain and the
    absorbed MLA order, the absorbed graphed step against the eager one.
    Then fp32: both orders serve under the graph and must give the same
    tokens; teacher-forced eager runs of the two orders compare routing and
    logits as the olmoe phase does, and say where the tokens part if they
    do. MLA has no TPU kernel in the reference, so no kernel launches."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.models import common as cc
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.models import mlp

    torch.cuda.empty_cache()
    full = get_config(DEEPSEEK["arch"])
    cfg = dataclasses.replace(full, segments=(
        full.segments[0], dataclasses.replace(full.segments[1], count=1)))
    cut = {"layers": f"{full.n_layers} -> {cfg.n_layers}",
           "kept": "layer 0 (dense MLP) and one MoE layer"}
    b, s, gen_n = DEEPSEEK["batch"], DEEPSEEK["prompt"], DEEPSEEK["gen"]
    max_len = s + gen_n
    params = dlm.init_params(cfg, seed=DEEPSEEK["seed"], device=device)
    n_params = dlm.param_count(params)
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=DEEPSEEK["seed"]), 0)
    tokens = torch.as_tensor(batch["tokens"], device=device)
    orders, peaks = {}, {}
    for absorb in (False, True):
        c = dataclasses.replace(cfg, mla_absorb=absorb)
        run = _serve_twice(torch, serve, c, params, batch, gen_n, FK, DK)
        gen = run["gen"]
        check(run["launches"] == {"flash_attention": 0, "decode_attention": 0},
              f"deepseek-v2 launched attention kernels: {run['launches']}")
        orders["absorbed" if absorb else "plain"] = {
            **_serve_fields(run), "sample": gen[0, :8].tolist()}
    c = dataclasses.replace(cfg, mla_absorb=True)
    fed = torch.as_tensor(gen, device=device)
    g_vs_e = _graph_vs_eager(torch, serve, params, c, {"tokens": tokens}, fed,
                             gen, max_len)
    emit("serve_deepseek_v2_graph_vs_eager", order="absorbed", **g_vs_e)
    check(g_vs_e["tokens_equal"] and g_vs_e["logits_bit_identical"],
          f"deepseek-v2's graphed absorbed decode differs from the eager one: "
          f"{g_vs_e}")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    gens32 = {}
    for absorb in (False, True):
        c = dataclasses.replace(cfg32, mla_absorb=absorb)
        gens32[absorb], _ = serve.serve_batch(c, params32, batch, gen_n,
                                              log=lambda *_: None)
    fed32 = torch.as_tensor(gens32[False], device=device)
    plain, rec_p, offsets = _teacher_forced(
        torch, dlm, mlp, cc, params32, dataclasses.replace(cfg32, mla_absorb=False),
        tokens, fed32, max_len, True)
    absorbed, rec_a, _ = _teacher_forced(
        torch, dlm, mlp, cc, params32, dataclasses.replace(cfg32, mla_absorb=True),
        tokens, fed32, max_len, True)
    del params32
    torch.cuda.empty_cache()
    flips = _routing_flips(torch, rec_p, rec_a, offsets, _moe_layers(cfg))
    cmp32 = _compare_routed(torch, absorbed, plain, flips)
    same = bool((gens32[False] == gens32[True]).all())
    parted = None
    if not same:   # the earliest step at which a row's tokens differ
        rows, steps = (gens32[False] != gens32[True]).nonzero()
        j = int(steps.min())
        bb = int(rows[steps == j][0])
        top2 = plain[bb, s - 1 + j].topk(2).values.tolist()
        parted = {"row": bb, "step": j, "position": s - 1 + j,
                  "plain_top2_logits": top2,
                  "routing_flipped_before": flips["first_position_reached"]
                  .get(bb, 1 << 30) <= s - 1 + j}
    emit("serve_deepseek_v2", arch=DEEPSEEK["arch"], cut=cut, dtype=cfg.dtype,
         layers=cfg.n_layers, d_model=cfg.d_model, params=n_params, batch=b,
         prompt_tokens=s, gen_tokens=gen_n, orders_bf16=orders,
         fp32_orders_same_tokens=same, fp32_orders_parted=parted,
         routing_fp32_plain_vs_absorbed=flips,
         fp32_logits_absorbed_vs_plain=cmp32)
    check(flips["real_flipped_tokens"] == 0,
          f"deepseek-v2's routing differs between the MLA orders away from a "
          f"near tie: {flips}")
    check(cmp32["ok"] and cmp32["flipped_row_share"] <= MAX_FLIPPED_ROWS,
          f"fp32 deepseek-v2 logits of the two MLA orders differ: {cmp32}")
    check(same or (parted["routing_flipped_before"]
                   or parted["plain_top2_logits"][0]
                   - parted["plain_top2_logits"][1] <= TOL32),
          f"the fp32 MLA orders part away from a near tie: {parted}")


SMALL_FAMILIES = (("jamba-1.5-large-398b", True), ("xlstm-125m", True),
                  ("xlstm-125m", False))


def phase_serve_families_small(torch, device, FK, DK) -> dict:
    """jamba-1.5-large (7 Mamba + 1 attention a block, MoE on every other
    layer) and xlstm-125m (mLSTM + sLSTM) under ``reduce_for_smoke`` (fp32,
    2 blocks, d 32), and xlstm-125m at full size (12 layers, d_model 768,
    bf16): ``serve_batch`` with the graphed decode step (4 prompts of 1024
    at full size, 2 of 32 reduced; 64 and 16 generated), whose tokens must
    equal an eager greedy loop's, with the graphed step's logits bit for bit
    the eager ones'. jamba's attention layers must launch both attention
    kernels. jamba at full width fits no card (PERF.md), so it runs reduced
    only. xlstm's sLSTM prefill is a loop over the prompt, host-bound."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.models import decoder_lm as dlm

    torch.cuda.empty_cache()
    out = {}
    for arch, reduced in SMALL_FAMILIES:
        cfg = get_config(arch)
        if reduced:
            cfg = dataclasses.replace(reduce_for_smoke(cfg), remat=False)
        b, s, gen_n = (2, 32, 16) if reduced else (4, 1024, 64)
        params = dlm.init_params(cfg, seed=0, device=device)
        batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                                seed=0), 0)
        run = _serve_twice(torch, serve, cfg, params, batch, gen_n, FK, DK)
        gen, launches = run["gen"], run["launches"]
        n_attn = sum(seg.count * sum(l.kind == "attn" for l in seg.layers)
                     for seg in cfg.segments)
        check(launches == {"flash_attention": n_attn,
                           "decode_attention": n_attn * gen_n},
              f"{arch} serve launches {launches}, want {n_attn} flash and "
              f"{n_attn * gen_n} decode")
        tokens = torch.as_tensor(batch["tokens"], device=device)
        fed = torch.as_tensor(gen, device=device)
        g_vs_e = _graph_vs_eager(torch, serve, params, cfg, {"tokens": tokens},
                                 fed, gen, s + gen_n)
        key = f"{arch}{' reduced' if reduced else ''}"
        emit("serve_family", arch=arch, reduced=reduced, dtype=cfg.dtype,
             layers=cfg.n_layers, d_model=cfg.d_model,
             kinds=sorted({f"{l.kind}+{l.mlp}" for l in cfg.layer_list()}),
             params=dlm.param_count(params), batch=b, prompt_tokens=s,
             gen_tokens=gen_n, **_serve_fields(run), launches=launches,
             graph_vs_eager=g_vs_e)
        check(g_vs_e["tokens_equal"] and g_vs_e["logits_bit_identical"],
              f"{key}: the graphed decode differs from the eager one: {g_vs_e}")
        out[key] = launches
        del params
        torch.cuda.empty_cache()
    return out


# -- the encoder-decoder and VLM families ---------------------------------------
WHISPER = dict(arch="whisper-small", batch=4, prompt=384, gen=64, seed=0)
INTERNVL = dict(arch="internvl2-1b", batch=4, prompt=1024, gen=64, seed=0)
PHI3 = dict(arch="phi3-mini-3.8b", batch=4, prompt=1024, gen=64, seed=0)


def _fp32_kernels_vs_plain(torch, serve, api, cfg, params, batch, fed,
                           max_len) -> dict:
    """The same weights upcast to fp32: ``serve_batch`` (kernels, graphed
    decode) generates tokens; then the prefill and teacher-forced decode
    steps fed those tokens, with ``use_flash`` on and off, give (B, gen, V)
    logits that must agree within TOL32 on every row (no routing here).
    Where the plain path's greedy token differs from a served one, its top
    two logits must be within TOL32 (a near tie)."""
    from repro_torch._tree import tree_map
    from repro_torch.models import common as cc
    from repro_torch.training.train_step import device_batch, make_prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    gen32, _ = serve.serve_batch(cfg32, params32, batch, fed.shape[1],
                                 log=lambda *_: None)
    fed32 = torch.as_tensor(gen32, device=fed.device)
    inputs32 = device_batch(cfg32, batch, fed.device)
    s = _first_decode_pos(cfg32, inputs32)
    prefill = make_prefill(cfg32, api)
    logits = {}
    for flash in (True, False):
        cc.RUNTIME["use_flash"] = flash
        with torch.no_grad():
            last, caches = prefill(params32, inputs32, max_len)
            rows = [last[:, -1]]
            for i in range(fed32.shape[1] - 1):
                step, caches = api.decode_step(params32, cfg32,
                                               fed32[:, i:i + 1], s + i, caches)
                rows.append(step[:, -1])
        logits[flash] = torch.stack(rows, dim=1).float()
        del caches
    cc.RUNTIME["use_flash"] = True
    del params32
    torch.cuda.empty_cache()
    on, off = logits[True], logits[False]
    check(bool(torch.isfinite(on).all() and torch.isfinite(off).all()),
          f"{cfg.name}: fp32 logits are not finite")
    ok_p, err_p = _close(torch, on[:, 0], off[:, 0], TOL32)
    ok_d, err_d = _close(torch, on[:, 1:], off[:, 1:], TOL32)
    greedy = off.argmax(-1)
    differ = greedy != fed32
    top2 = off.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1])[differ]
    return {"prefill_logits_max_abs_err": err_p, "prefill_ok": ok_p,
            "decode_logits_max_abs_err": err_d, "decode_ok": ok_d, "tol": TOL32,
            "plain_greedy_agreement_with_served": 1 - differ.float().mean().item(),
            "plain_greedy_differs_at_near_tie_only":
                bool((margins <= TOL32).all()),
            "plain_greedy_margins_where_differ": margins.tolist()[:8],
            "sample": gen32[0, :8].tolist()}


def _phase_serve_family(torch, device, FK, DK, spec: dict, phase: str) -> dict:
    """One model of the encoder-decoder or VLM family at its config's full
    width, bf16, random weights from a seeded generator on the card,
    through ``serve_batch`` (its frames or patches from ``make_batch``, fed
    in the params' dtype; the decode step replayed from one CUDA graph),
    with the launches counted from zero around the timed call: the flash
    kernel once per causal self-attention layer of the prefill, the decode
    kernel once per decoder layer and generated token. The graphed step
    against the eager one, bit for bit; decode and prefill profiles; then
    the fp32 kernels against the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.models.registry import get_api
    from repro_torch.training.train_step import device_batch

    torch.cuda.empty_cache()
    cfg = get_config(spec["arch"])
    api = get_api(cfg)
    b, s, gen_n = spec["batch"], spec["prompt"], spec["gen"]
    n_layers = cfg.n_layers           # the decoder's
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=spec["seed"], device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=spec["seed"]), 0)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    inputs = device_batch(cfg, batch, device)
    max_len = _first_decode_pos(cfg, inputs) + gen_n
    run = _serve_twice(torch, serve, cfg, params, batch, gen_n, FK, DK)
    _record_served(torch, cfg, params, batch, gen_n, run)
    gen, launches = run["gen"], run["launches"]
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * gen_n},
          f"{cfg.name} serve launches {launches}, want {n_layers} flash and "
          f"{n_layers * gen_n} decode")
    fed = torch.as_tensor(gen, device=device)
    g_vs_e = _graph_vs_eager(torch, serve, params, cfg, inputs, fed, gen,
                             max_len)
    emit(f"{phase}_graph_vs_eager", **g_vs_e)
    check(g_vs_e["tokens_equal"] and g_vs_e["logits_bit_identical"],
          f"{cfg.name}'s graphed decode differs from the eager one: {g_vs_e}")
    gprof = _profile_decode_graph(torch, serve, params, cfg, inputs, max_len, DK)
    emit(f"{phase}_decode_graph_profile", **gprof)
    check(gprof["decode_kernels_per_step"] == n_layers,
          f"a profiled {cfg.name} replay ran {gprof['decode_kernels_per_step']} "
          f"decode kernels per step, want {n_layers}")
    emit(f"{phase}_prefill_profile",
         **_profile_prefill(torch, params, cfg, inputs, max_len))
    n_params = dlm.param_count(params)
    del inputs
    cmp32 = _fp32_kernels_vs_plain(torch, serve, api, cfg, params, batch, fed,
                                   max_len)
    del params
    torch.cuda.empty_cache()
    shapes = {k: list(v.shape) for k, v in batch.items()}
    emit(phase, arch=spec["arch"], family=cfg.family, dtype=cfg.dtype,
         layers=n_layers, encoder_layers=sum(
             seg.count * len(seg.layers) for seg in cfg.encoder_segments),
         d_model=cfg.d_model, params=n_params, init_s=t_init, batch=b,
         prompt_tokens=s, gen_tokens=gen_n, max_len=max_len, inputs=shapes,
         **_serve_fields(run), launches=launches,
         fp32_kernels_vs_plain=cmp32, sample=gen[0, :8].tolist())
    check(cmp32["prefill_ok"] and cmp32["decode_ok"],
          f"fp32 {cfg.name} logits with the kernels differ from the plain "
          f"path: {cmp32}")
    check(cmp32["plain_greedy_differs_at_near_tie_only"],
          f"the fp32 plain path's greedy tokens part from {cfg.name}'s served "
          f"ones away from a near tie: {cmp32}")
    return launches


def phase_serve_whisper_small(torch, device, FK, DK) -> dict:
    """whisper-small at its config's widths (arXiv:2212.04356; 12 encoder
    and 12 decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab
    51,968), no cut: 4 x 1,500 encoder frames (30 s of audio), prompts of
    384 tokens, 64 generated (max_len 448, the decoder's context). The
    non-causal encoder and the cross-attention take the plain path, as in
    the reference; the flash kernel runs on the 12 decoder layers per
    prefill, the decode kernel on 12 per step."""
    return _phase_serve_family(torch, device, FK, DK, WHISPER,
                               "serve_whisper_small")


def phase_serve_internvl2_1b(torch, device, FK, DK) -> dict:
    """internvl2-1b at its config's widths (arXiv:2404.16821; 24 layers,
    d_model 896, 14 heads over 2 kv heads of 64, d_ff 4,864, vocab 151,808,
    vit_dim 1,024), no cut: 4 x (256 patches + 1,024 prompt tokens), 64
    generated (max_len 1,344). Both kernels run at GQA group 7: 24 flash
    launches per prefill, 24 decode launches per step."""
    return _phase_serve_family(torch, device, FK, DK, INTERNVL,
                               "serve_internvl2_1b")


def phase_serve_phi3_mini(torch, device, FK, DK) -> dict:
    """phi3-mini at its config's widths (arXiv:2404.14219; 32 layers,
    d_model 3,072, 32 heads of 96 over 32 kv heads, d_ff 8,192, vocab
    32,064), no cut: prompts of 1,024 tokens at B 4, 64 generated (max_len
    1,088). Head dim 96 runs at the kernels' width 128, read unpadded: 32
    flash launches per prefill, 32 decode launches per step."""
    return _phase_serve_family(torch, device, FK, DK, PHI3, "serve_phi3_mini")


def _attn_time_cases(torch, F, FK, FR, DK, DR):
    """The serve shapes: prefill of a global (causal) and a local (window
    512) layer, and one decode step of the global cache (T 1088, valid up
    to the middle of generation) and of a local ring (T 512, all valid);
    and phi3-mini's attention (32 heads, 32 kv heads, head_dim 96, run at
    width 128, read unpadded): a prefill of 1 x 1024 tokens and a decode
    step at B 4 against T 1088; the same heads at head_dim 80 (B 4 x 1024
    and T 1088), a head dim the kernels refused before they took any D up
    to 256; olmoe-1b-7b's (16 heads, 16 kv heads, head_dim 128) at its
    serve shapes, B 4 x 1024 and T 1088; internvl2-1b's (14 heads over 2 kv heads: G 7, head_dim 64), a
    prefill of 4 x (256 patches + 1024 tokens) and a step against T 1344;
    whisper-small's decoder (12 heads, 12 kv heads, head_dim 64), a
    prefill of 4 x 384 and a step against T 448; and gemma3-1b's shapes at
    head_dim 512 (bf16, two column passes of 256) and in fp16 at its own
    head_dim 256. Each case carries its dtype."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE["arch"])
    spec_local = cfg.segments[0].layers[0].attn
    phi3 = get_config("phi3-mini-3.8b").segments[0].layers[0].attn
    olmoe = get_config(OLMOE["arch"]).segments[0].layers[0].attn
    ivl = get_config(INTERNVL["arch"]).segments[0].layers[0].attn
    whisper = get_config(WHISPER["arch"]).segments[0].layers[0].attn
    b, s = SERVE["batch"], SERVE["prompt"]
    max_len = s + SERVE["gen"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    # fp16 for the "fp16" rows, bf16 for every other
    dtype_of = lambda label: torch.float16 if label == "fp16" else torch.bfloat16
    elt = 2
    cases = {}
    gemma = (spec_local.n_heads, spec_local.n_kv_heads, spec_local.head_dim)
    phi = (phi3.n_heads, phi3.n_kv_heads, phi3.head_dim)
    d80 = (phi3.n_heads, phi3.n_kv_heads, 80)
    olm = (olmoe.n_heads, olmoe.n_kv_heads, olmoe.head_dim)
    g7 = (ivl.n_heads, ivl.n_kv_heads, ivl.head_dim)
    whi = (whisper.n_heads, whisper.n_kv_heads, whisper.head_dim)
    d512 = (spec_local.n_heads, spec_local.n_kv_heads, 512)
    ivl_s = get_config(INTERNVL["arch"]).n_patches + INTERNVL["prompt"]
    for label, window, b, s, (h, kvh, d) in (
            ("global", None, SERVE["batch"], SERVE["prompt"], gemma),
            ("local", spec_local.window, SERVE["batch"], SERVE["prompt"], gemma),
            ("phi3-mini", None, 1, SERVE["prompt"], phi),
            ("d80", None, SERVE["batch"], SERVE["prompt"], d80),
            ("olmoe", None, OLMOE["batch"], OLMOE["prompt"], olm),
            ("internvl2-1b", None, INTERNVL["batch"], ivl_s, g7),
            ("whisper-small", None, WHISPER["batch"], WHISPER["prompt"], whi),
            ("d512", None, SERVE["batch"], SERVE["prompt"], d512),
            ("fp16", None, SERVE["batch"], SERVE["prompt"], gemma)):
        rn = lambda *shape, dt=dtype_of(label): torch.randn(
            *shape, device="cuda", generator=gen).to(dt)
        q, k, v = rn(b, s, h, d), rn(b, s, kvh, d), rn(b, s, kvh, d)
        qpos = torch.arange(s, device="cuda")[:, None]
        kpos = torch.arange(s, device="cuda")[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        pairs = int(mask.sum().item())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        cases[("flash_attention", label)] = dict(
            shape=dict(B=b, S=s, H=h, KV=kvh, D=d, window=window),
            dtype=str(q.dtype).replace("torch.", ""),
            kernel=lambda q=q, k=k, v=v, w=window: FK.flash_attention(q, k, v, window=w),
            plain=lambda q=q, k=k, v=v, w=window: FR.attention_ref(q, k, v, window=w),
            library=lambda qt=qt, kt=kt, vt=vt, m=mask: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True),
            library_args=(qt, kt, vt, mask),
            nbytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
            flops=4 * d * pairs * b * h)
    b = SERVE["batch"]
    s = SERVE["prompt"]
    ivl_t = ivl_s + INTERNVL["gen"]
    whi_t = WHISPER["prompt"] + WHISPER["gen"]
    for label, t, n_valid, (h, kvh, d) in (
            ("global", max_len, s + SERVE["gen"] // 2, gemma),
            ("local", spec_local.window, spec_local.window, gemma),
            ("phi3-mini", max_len, s + SERVE["gen"] // 2, phi),
            ("d80", max_len, s + SERVE["gen"] // 2, d80),
            ("olmoe", max_len, s + SERVE["gen"] // 2, olm),
            ("internvl2-1b", ivl_t, ivl_s + INTERNVL["gen"] // 2, g7),
            ("whisper-small", whi_t, WHISPER["prompt"] + WHISPER["gen"] // 2, whi),
            ("d512", max_len, s + SERVE["gen"] // 2, d512),
            ("fp16", max_len, s + SERVE["gen"] // 2, gemma)):
        rn = lambda *shape, dt=dtype_of(label): torch.randn(
            *shape, device="cuda", generator=gen).to(dt)
        q, k, v = rn(b, 1, h, d), rn(b, t, kvh, d), rn(b, t, kvh, d)
        valid = torch.arange(t, device="cuda") < n_valid
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        cases[("decode_attention", label)] = dict(
            shape=dict(B=b, T=t, H=h, KV=kvh, D=d, valid=n_valid),
            dtype=str(q.dtype).replace("torch.", ""),
            kernel=lambda q=q, k=k, v=v, m=valid: DK.decode_attention(q, k, v, m),
            plain=lambda q=q, k=k, v=v, m=valid: DR.decode_attention_ref(q, k, v, m),
            library=lambda qt=qt, kt=kt, vt=vt, m=valid: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m[None, :], enable_gqa=True),
            library_args=(qt, kt, vt, valid[None, :]),
            # the valid slots' K/V, the query, the bool mask and the output
            nbytes=(2 * b * n_valid * kvh * d + 2 * q.numel()) * elt + t,
            flops=4 * d * n_valid * b * h)
    return cases


NEW_TIME_ROWS = ("d512", "fp16", "d512-fp16")   # rows that also name SDPA's backend


def _sdpa_backend(torch, q, k, v, attn_mask=None, is_causal=False) -> dict:
    """The backend SDPA's dispatcher picks for these (B, H, S, D) inputs
    (``torch._fused_sdp_choice``, the choice ``scaled_dot_product_attention``
    itself makes; no profiler session: the card's profiler loses its
    records after some tens of sessions)."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, is_causal,
                                     enable_gqa=True)
    return {"library_backend": SDPBackend(choice).name}


def phase_attention_times(torch, FK, FR, DK, DR, card) -> dict:
    """Kernel, plain version, SDPA yardstick (timed only, never used by the
    port) and bound, at the serve shapes, bf16. ``ms`` has an event pair
    around each call (continuity with earlier runs); for decode also
    ``ms_graphed`` (per call inside a graph of 100 calls: no per-call event
    or launch cost) and ``ms_cold`` (inputs from HBM), with the same two
    yardsticks for SDPA."""
    import torch.nn.functional as F
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    out = {}
    for (name, label), c in _attn_time_cases(torch, F, FK, FR, DK, DR).items():
        t_bytes = c["nbytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["flops"] / PEAK_BF16_FLOPS * 1e3
        row = {"layer": label, **c["shape"], "dtype": c["dtype"],
               "ms": _time_ms(torch, c["kernel"]),
               "plain_ms": _time_ms(torch, c["plain"]),
               "library_ms": _time_ms(torch, c["library"]),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": c["nbytes"], "flops": c["flops"]}
        if label in NEW_TIME_ROWS:   # the backend SDPA ran
            row.update(_sdpa_backend(torch, *c["library_args"]))
        if name == "flash_attention" and label in ("global", "local"):
            # gemma3-1b's training shape too (B 4, S 1024): per call inside
            # a graph of 100, as the training graph runs it
            row["ms_graphed"] = _time_graphed_ms(torch, c["kernel"])
        if name == "decode_attention":
            row.update(
                ms_graphed=_time_graphed_ms(torch, c["kernel"]),
                library_ms_graphed=_time_graphed_ms(torch, c["library"]),
                ms_cold=_time_cold_ms(torch, c["kernel"], flush),
                library_ms_cold=_time_cold_ms(torch, c["library"], flush))
            row["bound_share_graphed"] = row["bound_ms"] / row["ms_graphed"]
        emit("times", kernel=name, card=card, **_shares(row))
        out.setdefault(name, {})[label] = row
    return out


# -- training gemma3-1b --------------------------------------------------------
TRAIN = dict(arch="gemma3-1b", batch=4, seq=1024, steps=6, ckpt_every=3,
             seed=0, lr=3e-4)
BWD_REPLACES = "src/repro/kernels/flash_attention/kernel.py:71"  # its gradient


def phase_flash_bwd_check(torch, FK, FR) -> dict:
    """The backward kernel against the plain version's autograd (fp32
    math) on the sweep of ``tests/test_torch_flash_backward_gpu.py``: head
    dims, causal and window, GQA 1 / 4 / 8, ragged S and T, S 1, a window
    wider than S, gemma3-1b's training shapes, the bf16 body's edges
    (``BWD_EDGE_CASES``) and phi3-mini's attention (head_dim 96). Max abs
    error of dQ, dK, dV per dtype."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_flash_backward_gpu as FB
    errs = {}
    for case in FB.BWD_CASES + FB.BWD_EDGE_CASES + [FB.PHI3_CASE]:
        causal, window, dt = case[6], case[7], case[8]
        q, k, v, do = FB.bwd_inputs(case)
        got, _ = FB.kernel_grads(q, k, v, do, causal, window)
        want = FB.plain_grads(q, k, v, do, causal, window)
        torch.cuda.synchronize()
        tol = FB.TOL[dt]
        oks, e = zip(*(_close(torch, g, w, tol) for g, w in zip(got, want)))
        ok, e = all(oks), list(e)
        emit("kernel_check", kernel="flash_attention_bwd", case=list(case),
             dtype=dt, max_abs_err_dq_dk_dv=e,
             max_abs_ref_dq_dk_dv=[w.float().abs().max().item() for w in want],
             rtol=tol, atol=tol, ok=ok)
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"flash_attention_bwd gave non-finite values at {case}")
        check(ok, f"flash_attention_bwd disagrees with the plain autograd at "
                  f"{case}: max abs err dq/dk/dv {e}")
        prev = errs.get(dt, [0.0, 0.0, 0.0])
        errs[dt] = [max(a, b) for a, b in zip(prev, e)]
    emit("flash_attention_bwd_errors", max_abs_err_dq_dk_dv=errs)
    return {"float32": max(errs["float32"]), "bfloat16": max(errs["bfloat16"])}


# the bf16 backward's launches, in order
BWD_KERNELS = ("bwd_prep_kernel", "bwd_wgmma_kernel", "dkv_reduce_kernel")
# how far a call's profiled device time may lie from its event-timed ms
# before its split is not reported (each is one call, timed its own way)
SPLIT_SPAN = (0.5, 1.5)


def _kernel_split(call: dict, names, ms: float):
    """One profiled call's device ms by kernel (``_calls_profile``'s dict
    for that call): the activities whose names contain each of ``names``,
    the rest under "other", their sum under "total"; and None, or the
    reason the split is None: the profile holds none of ``names``, or its
    total lies outside ``SPLIT_SPAN`` times the event-timed ``ms``. A split
    that was not measured is not printed."""
    if not any(n in k for k in call for n in names):
        return None, f"the profile holds none of {list(names)}: {sorted(call)}"
    split = {n: sum(t for k, t in call.items() if n in k) for n in names}
    total = sum(call.values())
    split["other"] = total - sum(split.values())
    split["total"] = total
    lo, hi = SPLIT_SPAN
    if not lo * ms <= total <= hi * ms:
        return None, (f"the profiled total {total} ms lies outside "
                      f"{SPLIT_SPAN} x the timed {ms} ms")
    return split, None


def phase_flash_bwd_times(torch, FK, FR, card) -> dict:
    """The backward at gemma3-1b's training shape (B 4, S 1024, H 4, KV 1,
    D 256, bf16), global and window 512, and at phi3-mini's attention (B 1,
    S 1024, H 32, KV 32, D 96 run at width 128, causal): kernel (one call:
    prep, dK/dV, dQ and, when H > KV, the sum of the heads' partials), the
    same call's device time by kernel (``split_ms``: one call of every row
    under one shared profiler session, each in a range of its own
    (``_calls_profile``); null, with
    ``split_note``, when the profile does not hold the row's kernels or its
    total is far from the timed ms), its
    plain version (``attention_bwd_ref``: the same function from the same o
    and log-sum-exp), and one SDPA forward + backward as the library
    yardstick (timed only, never used by the port; causal flag for the
    global layers, a boolean mask for the window). Bound: bytes (q, k, v, o,
    dO and the log-sum-exp read, dq, dk, dv written) / 3.35 TB/s against
    the backward's five products over the visible pairs (S, dP, dV, dK, dQ:
    10 D flops a pair and head, at the true D) / 989 TFLOP/s. Also gemma3-1b's
    training shape at head_dim 512 in bf16 and fp16 (the wgmma body's wide
    instantiation: two column passes of 256, each recomputing S and dP over
    all of D) and in fp16 at its own head_dim 256 (the wgmma body's f16
    instructions), each naming the backend SDPA ran."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    spec = get_config(TRAIN["arch"]).segments[0].layers[0].attn
    phi3 = get_config("phi3-mini-3.8b").segments[0].layers[0].attn
    gemma = (TRAIN["batch"], spec.n_heads, spec.n_kv_heads, spec.head_dim)
    phi = (1, phi3.n_heads, phi3.n_kv_heads, phi3.head_dim)
    s = TRAIN["seq"]
    d512 = (TRAIN["batch"], spec.n_heads, spec.n_kv_heads, 512)
    gen = torch.Generator(device="cuda").manual_seed(2)
    out, kernels = {}, {}
    for label, window, (b, h, kvh, d) in (("global", None, gemma),
                                          ("local", spec.window, gemma),
                                          ("phi3-mini", None, phi),
                                          ("d512", None, d512),
                                          ("fp16", None, gemma),
                                          ("d512-fp16", None, d512)):
        dt = torch.float16 if "fp16" in label else torch.bfloat16
        rn = lambda *shape, dt=dt: torch.randn(*shape, device="cuda",
                                               generator=gen).to(dt)
        q, k, v, do = rn(b, s, h, d), rn(b, s, kvh, d), rn(b, s, kvh, d), rn(b, s, h, d)
        o, lse = FK.flash_attention(q, k, v, window=window, return_lse=True)
        qpos = torch.arange(s, device="cuda")[:, None]
        kpos = torch.arange(s, device="cuda")[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        pairs = int(mask.sum().item())
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def library(qt=qt, kt=kt, vt=vt, dot=dot, m=mask, w=window):
            y = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=None if w is None else m,
                is_causal=w is None, enable_gqa=True)
            torch.autograd.grad(y, (qt, kt, vt), dot)

        kernel = lambda q=q, k=k, v=v, o=o, lse=lse, do=do, w=window: \
            FK.flash_attention_bwd(q, k, v, o, lse, do, window=w)
        nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
        flops = 10 * d * pairs * b * h
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        body = FK.dispatch(d, q.dtype, [], backward=True)["body"]
        row = {"layer": label, "B": b, "S": s, "H": h, "KV": kvh, "D": d,
               "window": window, "dtype": str(dt).replace("torch.", ""),
               "body": body, "ms": _time_ms(torch, kernel),
               "plain_ms": _time_ms(torch, lambda: FR.attention_bwd_ref(
                   q, k, v, o, lse, do, window=window)),
               "library_ms": _time_ms(torch, library),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        if label in NEW_TIME_ROWS:
            row.update(_sdpa_backend(torch, qt, kt, vt, None, True))
        out[label] = row
        kernels[label] = kernel
    # every row's split from one profiler session
    profiled, note = _calls_profile(torch, list(kernels.values()))
    for i, row in enumerate(out.values()):
        row["split_ms"], row_note = (None, note) if profiled is None else \
            _kernel_split(profiled[i], BODY_KERNELS[row["body"]], row["ms"])
        if row_note:
            row["split_note"] = row_note
        emit("times", kernel="flash_attention_bwd", card=card, **_shares(row))
    return out


def _profile_train_step(torch, step_fn, state, batch) -> dict:
    """One train step (the last state, the next batch) unprofiled, then one
    under torch.profiler (CUDA activity): host wall time, device-busy time
    (kernels' own device time), the device's idle share, kernels per step,
    the flash kernels' part (the backward's also as a share of device-busy
    time) and the largest kernels. The new states are
    dropped."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m = step_fn(state, batch)
    float(m["loss"])
    wall_unprofiled = time.perf_counter() - t0
    del new, m
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del new, m
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_dev_time(e) for e in kernels)
    part = lambda *names: sum(_dev_time(e) for e in kernels
                              if any(n in e.key for n in names)) / 1e3
    top = sorted(kernels, key=_dev_time, reverse=True)[:10]
    return {"wall_ms": wall * 1e3, "wall_ms_unprofiled": wall_unprofiled * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_idle_share_unprofiled": 1.0 - busy_us / 1e6 / wall_unprofiled,
            "kernels_per_step": sum(e.count for e in kernels),
            "flash_fwd_ms": part("flash_tc_kernel"),
            "flash_bwd_ms": part(*BWD_KERNELS),
            "flash_bwd_share": part(*BWD_KERNELS) / (busy_us / 1e3),
            "top_kernels": [[e.key[:100], _dev_time(e) / 1e3, e.count] for e in top]}


def phase_train(torch, device, FK, card) -> dict:
    """gemma3-1b at full width (26 layers, bf16, remat on as configured,
    ``ce_chunk`` 512), random weights from a seed, batch 4 x 1024 tokens,
    through ``train_loop``: 6 straight steps with a checkpoint every 3 into
    build/train_ckpt, then, with step 6's checkpoint removed, a fresh loop
    that resumes from step 3 to 6, whose losses must equal the straight
    run's at tests/test_train_resume.py's rtol 1e-5 / atol 1e-6. On the
    card ``train_loop`` runs its first step eagerly and replays a captured
    graph of the donating step from the second on (``TrainGraph``). Launch
    counts of the straight run, step times (each step's own wall time:
    ``log_every`` 1 reads its metrics on the host; step 0 holds the warm-up
    and the capture), tokens/s, peak device memory, and a profile of one
    more step, eager (the pure step) and graphed (a replay), each with its
    peak memory."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import common as cc
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    cfg = get_config(TRAIN["arch"])
    b, s, steps, every = (TRAIN[k] for k in ("batch", "seq", "steps", "ckpt_every"))
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(global_batch=b, seq_len=s, ckpt_dir=ckpt, ckpt_every=every,
              keep_k=2, lr=TRAIN["lr"], seed=TRAIN["seed"], log_every=1,
              log=lambda *_: None, schedule_steps=steps, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    t0 = time.perf_counter()
    state, straight = launch_train.train_loop(cfg, steps, **kw)
    loop_s = time.perf_counter() - t0
    launches = dict(FK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    HELD["train " + cfg.name] = {"peak_mem_bytes": peak, "batch": b, "seq": s,
                                 "history": straight, "launches": launches}
    n_layers = cfg.n_layers
    check(launches == {"flash_attention": 2 * n_layers * steps,
                       "flash_attention_bwd": n_layers * steps},
          f"train launches {launches}, want {2 * n_layers * steps} forward and "
          f"{n_layers * steps} backward")
    check(len(straight) == steps and all(
        math.isfinite(h[k]) for h in straight for k in ("loss", "grad_norm")),
        f"train metrics are not finite: {straight}")
    check(CheckpointManager(ckpt).committed_steps() == [every, steps],
          "the straight run did not commit steps 3 and 6")
    n_params = dlm.param_count(state.params)
    del state
    torch.cuda.empty_cache()

    shutil.rmtree(os.path.join(ckpt, f"step_{steps:08d}"))
    logs = []
    t0 = time.perf_counter()
    state, resumed = launch_train.train_loop(cfg, steps, **{**kw, "log": logs.append})
    resume_s = time.perf_counter() - t0
    check(f"resumed from step {every}" in logs, f"no resume from step {every}: {logs}")
    check([h["step"] for h in resumed] == list(range(every, steps)),
          f"resumed steps {[h['step'] for h in resumed]}")
    by_step = {h["step"]: h for h in straight}
    loss_err = [abs(h["loss"] - by_step[h["step"]]["loss"]) for h in resumed]
    resume_ok = all(abs(h["loss"] - by_step[h["step"]]["loss"])
                    <= 1e-6 + 1e-5 * abs(by_step[h["step"]]["loss"]) for h in resumed)

    opt_cfg = AdamWConfig(learning_rate=TRAIN["lr"], warmup_steps=min(20, steps // 10),
                          total_steps=steps)
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=TRAIN["seed"]), steps)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    saved = {k: cc.RUNTIME[k] for k in ("use_flash", "q_chunk")}
    cc.RUNTIME.update(use_flash=True, q_chunk=0)   # as train_loop sets on CUDA
    try:
        # the eager (pure) step, then the graphed donating step on the same
        # state and batch; each one's peak counted from its own start
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = _profile_train_step(torch, make_train_step(cfg, opt_cfg), state, batch)
        prof["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graph = launch_train.TrainGraph(
            make_train_step(cfg, opt_cfg, donate=True), state)
        t0 = time.perf_counter()
        float(graph(batch)["loss"])      # the eager first step and the capture
        first_ms = (time.perf_counter() - t0) * 1e3
        prof_graph = _profile_train_step(
            torch, lambda st, bt: (st, graph(bt)), state, batch)
        prof_graph["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        prof_graph["first_call_ms"] = first_ms
        prof_graph["reserved_bytes"] = torch.cuda.memory_reserved()
        graph.release()
    finally:
        cc.RUNTIME.update(saved)
    del state
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    step_ms = [h["step_s"] * 1e3 for h in straight]
    warm_ms = statistics.median(step_ms[1:])   # the graph's replays
    emit("train", arch=TRAIN["arch"], dtype=cfg.dtype, layers=n_layers,
         graphed=True, first_step_ms=step_ms[0],
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
         remat=cfg.remat, ce_chunk=cfg.ce_chunk, batch=b, seq=s, steps=steps,
         card=card, step_ms=step_ms, step_ms_median_warm=warm_ms,
         step_ms_median_all=statistics.median(step_ms),
         tokens_per_s=b * s / (warm_ms / 1e3), peak_mem_bytes=peak,
         loop_s=loop_s, resume_loop_s=resume_s,
         losses=[h["loss"] for h in straight],
         grad_norms=[h["grad_norm"] for h in straight],
         lrs=[h["lr"] for h in straight],
         resumed_losses=[h["loss"] for h in resumed],
         resumed_grad_norms=[h["grad_norm"] for h in resumed],
         resumed_loss_abs_err=loss_err, resume_rtol=1e-5, resume_atol=1e-6,
         launches=launches,
         launches_per_step={k: n / steps for k, n in launches.items()})
    emit("train_profile", card=card, step="eager", **prof)
    emit("train_profile", card=card, step="graphed", **prof_graph)
    check(resume_ok, f"resumed losses differ from the straight run's: {loss_err}")
    return launches


def phase_train_mesh_1card(torch, device, FK, card) -> dict:
    """``phase_train``'s run on a device mesh: gemma3-1b at full width
    (bf16, remat, ``ce_chunk`` 512, the flash kernels), B 4 x 1024, the
    same seed and data, through ``train_loop(mesh=make_mesh_for(1))``: NCCL
    with world size 1, mesh ``(data 1, model 1)``, the state ``DTensor``s
    placed by ``train_state_specs`` (on one rank every leaf is whole), the
    first step eager over ``DTensor``s and the rest replays of the captured
    step. 6 straight steps with a checkpoint every 3 under
    build/train_mesh_ckpt; then, with step 6's removed, a mesh loop that
    resumes from step 3. Checks: NCCL; the flash launches per step are
    ``phase_train``'s (2 x 26 forward with remat, 26 backward), run on the
    ranks' local shards; every loss within rtol 1e-5 of ``phase_train``'s
    plain loop (the report says whether they are equal bit for bit); the
    resumed losses within rtol 1e-5 / atol 1e-6 of the straight run's; the
    state stays ``DTensor``s. Reports the warm median step (graphed), the
    eager first step, the peak device memory and the leaves whose spec
    splits them (none is split on one rank). The process group is
    destroyed after."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.sharding import ShardingRules, param_specs

    cfg = get_config(TRAIN["arch"])
    b, s, steps, every = (TRAIN[k] for k in ("batch", "seq", "steps", "ckpt_every"))
    plain = HELD["train " + cfg.name]
    ckpt = os.path.join(ROOT, "build", "train_mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(global_batch=b, seq_len=s, ckpt_dir=ckpt, ckpt_every=every,
              keep_k=2, lr=TRAIN["lr"], seed=TRAIN["seed"], log_every=1,
              log=lambda *_: None, schedule_steps=steps, device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    mesh = make_mesh_for(1)
    try:
        backend = dist.get_backend()
        t0 = time.perf_counter()
        state, straight = launch_train.train_loop(cfg, steps, mesh=mesh, **kw)
        loop_s = time.perf_counter() - t0
        launches = dict(FK.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        state_leaves = leaves(state)
        all_dtensor = all(isinstance(t, DTensor) for t in state_leaves)
        specs = []            # a spec is a tuple: collect them, do not enter
        tree_map(lambda _, sp: specs.append(sp), state.params,
                 param_specs(ShardingRules(mesh=mesh, fsdp=False),
                             state.params))
        spec_split = sum(any(e is not None for e in sp) for sp in specs)
        shard_placed = sum(any(p.is_shard() for p in t.placements)
                           for t in state_leaves)
        committed = CheckpointManager(ckpt).committed_steps()
        del state, state_leaves
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(ckpt, f"step_{steps:08d}"))
        logs = []
        state, resumed = launch_train.train_loop(
            cfg, steps, mesh=mesh, **{**kw, "log": logs.append})
        del state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    plain_loss = {h["step"]: h["loss"] for h in plain["history"]}
    losses = [h["loss"] for h in straight]
    loss_rel = [abs(h["loss"] - plain_loss[h["step"]]) / abs(plain_loss[h["step"]])
                for h in straight]
    bitwise = all(h["loss"] == plain_loss[h["step"]] for h in straight)
    by_step = {h["step"]: h for h in straight}
    resume_err = [abs(h["loss"] - by_step[h["step"]]["loss"]) for h in resumed]
    resume_ok = all(abs(h["loss"] - by_step[h["step"]]["loss"])
                    <= 1e-6 + 1e-5 * abs(by_step[h["step"]]["loss"])
                    for h in resumed)
    step_ms = [h["step_s"] * 1e3 for h in straight]
    warm_ms = statistics.median(step_ms[1:])
    n_layers = cfg.n_layers
    emit("train_mesh_1card", arch=TRAIN["arch"], backend=backend,
         mesh=list(mesh.mesh.shape), card=card, dtype=cfg.dtype,
         batch=b, seq=s, steps=steps, graphed=True,
         first_step_ms=step_ms[0], step_ms=step_ms,
         step_ms_median_warm=warm_ms,
         plain_step_ms_median_warm=statistics.median(
             [h["step_s"] * 1e3 for h in plain["history"]][1:]),
         tokens_per_s=b * s / (warm_ms / 1e3), peak_mem_bytes=peak,
         plain_peak_mem_bytes=plain["peak_mem_bytes"], loop_s=loop_s,
         losses=losses, plain_losses=[plain_loss[h["step"]] for h in straight],
         loss_rel_err=loss_rel, losses_bit_for_bit=bitwise,
         resumed_losses=[h["loss"] for h in resumed],
         resumed_loss_abs_err=resume_err, state_leaves_dtensor=all_dtensor,
         param_leaves_split_by_spec=spec_split,
         state_leaves_placed_as_shards=shard_placed,
         committed_steps=committed, launches=launches,
         launches_per_step={k: n / steps for k, n in launches.items()})
    check(backend == "nccl", f"the one-card mesh trains over {backend}, not NCCL")
    check(all_dtensor, "the mesh loop's state is not DTensors")
    check(launches == {"flash_attention": 2 * n_layers * steps,
                       "flash_attention_bwd": n_layers * steps},
          f"mesh train launches {launches}, want {2 * n_layers * steps} "
          f"forward and {n_layers * steps} backward")
    check(committed == [every, steps],
          f"the mesh run committed steps {committed}, not {[every, steps]}")
    check(len(straight) == steps and max(loss_rel) <= 1e-5,
          f"mesh losses differ from the plain loop's: {loss_rel}")
    check(f"resumed from step {every}" in logs
          and [h["step"] for h in resumed] == list(range(every, steps)),
          f"the mesh loop did not resume from step {every}: {logs}")
    check(resume_ok, f"resumed mesh losses differ from the straight run's: "
          f"{resume_err}")
    return launches


# -- the cost and layout tools: the pricer, the dry-run, the mesh -------------
PRICED = (SERVE, OLMOE, WHISPER, INTERNVL)


def phase_price_serve(card) -> dict:
    """``serve_model_from_config`` at full width for the four served models,
    at their serve phases' batch, prompt and generated lengths, on the meta
    device (host only). Its weight bytes must equal the bytes of the params
    the serve phase held on the card, and its KV bytes per token x batch x
    cache length the bytes of that phase's caches (an integer: the per-token
    figure is their quotient). Prints flops per token and the decode
    efficiency they imply at the phase's measured rate."""
    from repro_torch.configs import get_config
    from repro_torch.serve.costs import serve_model_from_config
    rows = {}
    for spec in PRICED:
        cfg = get_config(spec["arch"])
        held = HELD[cfg.name]
        t0 = time.perf_counter()
        model = serve_model_from_config(cfg, batch=spec["batch"],
                                        prompt_len=spec["prompt"],
                                        gen_tokens=spec["gen"],
                                        seed=spec["seed"])
        price_s = time.perf_counter() - t0
        kv_total = model.kv_bytes_per_token * held["batch"] * held["max_len"]
        rows[spec["arch"]] = {
            "price_s": price_s, "batch": held["batch"],
            "max_len": held["max_len"],
            "weight_bytes": model.weight_bytes,
            "param_bytes_on_card": held["param_bytes"],
            "kv_bytes_per_token": model.kv_bytes_per_token,
            "kv_bytes_x_batch_x_max_len": kv_total,
            "cache_bytes_on_card": held["cache_bytes"],
            "prefill_flops_per_token": model.prefill_flops_per_token,
            "decode_flops_per_token": model.decode_flops_per_token,
            "decode_tokens_per_s": held["tokens_per_s"],
            "decode_efficiency": model.decode_flops_per_token
            * held["tokens_per_s"] / PEAK_BF16_FLOPS}
        check(model.weight_bytes == held["param_bytes"],
              f"{cfg.name}: priced weight bytes {model.weight_bytes} differ "
              f"from the {held['param_bytes']} held on the card")
        check(round(kv_total) == held["cache_bytes"]
              and abs(kv_total - held["cache_bytes"]) <= 1e-9 * kv_total,
              f"{cfg.name}: priced KV bytes {kv_total} differ from the "
              f"{held['cache_bytes']} of the caches on the card")
    emit("price_serve", card=card, peak_flops=PEAK_BF16_FLOPS, models=rows)
    return rows


def phase_dryrun_1chip(card) -> dict:
    """``run_cell`` on a (data 1, model 1) mesh with the card's ``HW`` for
    the four serve cells (a decode step at the serve phase's batch and cache
    length) and gemma3-1b's training cell (4 x 1024, AdamW). The predicted
    per-device argument bytes (params, caches or optimizer state, inputs)
    must be at most the peak the matching phase measured on the card; the
    gap is activations and temporaries, which a shape-only run does not
    see."""
    from repro_torch.analysis.roofline import HW
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import MeshShape
    one = MeshShape((1, 1), ("data", "model"))
    cells = []
    for spec in PRICED:
        held = HELD[get_config(spec["arch"]).name]
        cells.append((spec["arch"], ShapeSpec("serve_decode", held["max_len"],
                                              held["batch"], "decode"), held))
    held = HELD["train " + get_config(TRAIN["arch"]).name]
    cells.append((TRAIN["arch"], ShapeSpec("train", held["seq"], held["batch"],
                                           "train"), held))
    rows = []
    for arch, shape, held in cells:
        t0 = time.perf_counter()
        r = run_cell(arch, shape, False, {"q_chunk": 0}, verbose=False,
                     mesh=one, hw=HW())
        args = r["memory"]["argument_size_in_bytes"]
        rows.append({"arch": arch, "kind": shape.kind,
                     "batch": shape.global_batch, "seq": shape.seq_len,
                     "argument_bytes": args,
                     "output_bytes": r["memory"]["output_size_in_bytes"],
                     "alias_bytes": r["memory"]["alias_size_in_bytes"],
                     "peak_mem_bytes_on_card": held["peak_mem_bytes"],
                     "argument_over_peak": args / held["peak_mem_bytes"],
                     "bottleneck": r["roofline"]["bottleneck"],
                     "step_time_lower_bound_s":
                         r["roofline"]["step_time_lower_bound_s"],
                     "wall_s": time.perf_counter() - t0})
        check(args <= held["peak_mem_bytes"],
              f"{arch} {shape.kind}: predicted argument bytes {args} exceed "
              f"the {held['peak_mem_bytes']} peak measured on the card")
    emit("dryrun_1chip", card=card, cells=rows)
    return rows


DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")


def start_dryrun_production() -> dict:
    """Start the production dry-run as a user runs it, ``python -m
    repro_torch.launch.dryrun --arch all --shape all --both-meshes``, in a
    process of its own beside the card's phases: it is host only (meta
    tensors, no device; the card is hidden from it) and takes minutes of
    one core. Killed at exit if still running."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    os.makedirs(DRYRUN_OUT)
    log = open(os.path.join(DRYRUN_OUT, "dryrun.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--both-meshes", "--out", DRYRUN_OUT],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "log": log, "t0": time.time()}


def phase_dryrun_production(dry: dict, card) -> dict:
    """Every arch x shape on the shape-only 16x16 and 2x16x16 meshes with the
    card's ``HW`` and the reference's dry-run knobs (each program priced
    once for both meshes), from the process ``start_dryrun_production``
    began: fits or not (arguments + outputs - aliases against 80 GB, a
    lower bound), the bottleneck, the step time's lower bound. Every cell
    must run or be a documented skip."""
    rc = dry["proc"].wait(timeout=900)
    joined = time.time() - dry["t0"]
    dry["log"].close()
    # the process's own time: from its start to its last line (its summary)
    wall = os.path.getmtime(os.path.join(DRYRUN_OUT, "dryrun.log")) - dry["t0"]
    with open(os.path.join(DRYRUN_OUT, "dryrun.log")) as f:
        summary = [l for l in f.read().splitlines()
                   if l.startswith("DRYRUN SUMMARY")]
    rows = []
    for name in sorted(os.listdir(DRYRUN_OUT)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(DRYRUN_OUT, name)) as f:
            r = json.load(f)
        row = {k: r[k] for k in ("arch", "shape", "mesh")}
        if "skipped" in r:
            rows.append({**row, "skipped": r["skipped"]})
            continue
        rows.append({**row, "fits": r["fits_lower_bound"],
                     "resident_bytes": r["resident_bytes_lower_bound"],
                     "bottleneck": r["roofline"]["bottleneck"],
                     "lower_bound_s": r["roofline"]["step_time_lower_bound_s"],
                     "price_s": r["price_s"]})
    emit("dryrun_production", card=card, rc=rc, wall_s=wall,
         joined_after_s=joined, summary=summary, cells=rows)
    check(rc == 0 and len(rows) == 80 and all(
        "skipped" in r or "fits" in r for r in rows),
        f"the production dry-run failed (rc {rc}, {len(rows)} cells): "
        f"{summary}")
    return {"wall_s": wall, "cells": len(rows)}


def phase_mesh_1card(torch, device) -> dict:
    """``make_mesh_for(1)`` on the card over NCCL; gemma3-1b's params (full
    width, bf16, the serve phase's seed) distributed by ``param_shardings``:
    every local shard equals its original bit for bit, and ``serve_batch``
    over the local shards (one prefill, one graphed decode step) gives the
    original params' tokens. The process group is destroyed after."""
    import torch.distributed as dist

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.parallel.sharding import (ShardingRules,
                                               distribute_params,
                                               param_shardings)

    cfg = get_config(SERVE["arch"])
    params = dlm.init_params(cfg, seed=SERVE["seed"], device=device)
    batch = make_batch(cfg, SyntheticConfig(global_batch=SERVE["batch"],
                                            seq_len=128, seed=SERVE["seed"]), 0)
    t0 = time.perf_counter()
    mesh = make_mesh_for(1)
    try:
        rules = ShardingRules(mesh=mesh)
        placements = []       # a leaf's placements are a tuple: collect them
        tree_map(lambda _, pl: placements.append(pl), params,
                 param_shardings(rules, params))
        local = tree_map(lambda d: d.to_local(),
                         distribute_params(rules, params))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    mesh_s = time.perf_counter() - t0
    exact = all(torch.equal(a, b) for a, b in zip(leaves(local),
                                                  leaves(params)))
    gen_a, _ = serve.serve_batch(cfg, params, batch, 2, log=lambda *_: None)
    gen_b, _ = serve.serve_batch(cfg, local, batch, 2, log=lambda *_: None)
    n_sharded = sum(any(p.is_shard() for p in pl) for pl in placements)
    emit("mesh_1card", backend=backend, mesh=list(mesh.mesh.shape),
         leaves=len(placements), sharded_leaves=n_sharded,
         local_equals_original=exact,
         tokens_equal=bool((gen_a == gen_b).all()), mesh_s=mesh_s)
    del params, local
    torch.cuda.empty_cache()
    check(backend == "nccl", f"the one-card mesh runs over {backend}, not NCCL")
    check(n_sharded > 0, "no param is placed as a shard on the one-card mesh")
    check(exact, "a local shard on the one-card mesh differs from its param")
    check(bool((gen_a == gen_b).all()),
          "serving the mesh's local shards gave other tokens")
    return {"local_equals_original": exact}


# -- the GNN trainer's captured programs and the example twins ----------------
@contextlib.contextmanager
def _capture_clock(torch):
    """Host seconds spent inside CUDA graph captures during the block, and
    their number: ``capture_begin`` to ``capture_end`` (a capture runs
    nothing on the card)."""
    cls = torch.cuda.CUDAGraph
    begin, end = cls.capture_begin, cls.capture_end
    out = {"captures": 0, "capture_s": 0.0}
    started = []

    def timed_begin(self, *a, **kw):
        started.append(time.perf_counter())
        return begin(self, *a, **kw)

    def timed_end(self, *a, **kw):
        try:
            return end(self, *a, **kw)
        finally:
            out["captures"] += 1
            out["capture_s"] += time.perf_counter() - started.pop()

    cls.capture_begin, cls.capture_end = timed_begin, timed_end
    try:
        yield out
    finally:
        cls.capture_begin, cls.capture_end = begin, end


def _profile_step(torch, trainer, ds) -> dict:
    """One more step of a trainer (``run(1, ...)``: replays, or the eager
    steps) under torch.profiler: a joint step, a scan or bucketed epoch
    (one update per graph), or one sequential step (the example's copy in,
    the step, its host sync). Host wall ms from synchronize to
    synchronize, device-busy ms (kernels' own device time), the idle share,
    the kernels launched and the updates made."""
    from torch.profiler import ProfilerActivity, profile

    unit = ds[:1] if trainer.mode == "sequential" else ds
    trainer.run(1, unit)
    # the profiler has once recorded no device activity for a replay (one
    # case of six in one run): profile again, up to three windows
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run(1, unit)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    busy_us = sum(_dev_time(e) for e in kernels)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernels": sum(e.count for e in kernels),
            "updates": 1 if trainer.mode == "joint" else len(unit),
            "profiled_windows": attempt}


def _train_cases():
    """(case, tasks, dataset, mode, steps): fleet46's plan, the evaluator's
    ``trained_gnn``, plan_bench's ``training_throughput`` (before and
    after), a ragged dataset in two buckets and the per-graph scan."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import train as gnn_train
    from repro_torch.core.graph import paper_fleet46
    from repro_torch.sim.scenarios import SIM_TASKS

    mk = gnn_train.make_dataset
    fleet46 = mk(4, cm.FOUR_TASKS, n_nodes=46, seed=1, label_frac=0.8)
    fleet46.append(gnn_train.make_example(paper_fleet46(), cm.FOUR_TASKS,
                                          seed=0))
    sim = list(SIM_TASKS)
    evaluator = mk(3, sim, n_nodes=12, seed=11, label_frac=0.8)
    bench = mk(64, cm.FOUR_TASKS, n_nodes=16, seed=7, label_frac=0.8)
    ragged = (mk(3, cm.FOUR_TASKS, n_nodes=12, seed=2, label_frac=0.8)
              + mk(3, cm.FOUR_TASKS, n_nodes=40, seed=5, label_frac=0.8))
    return [("fleet46", cm.FOUR_TASKS, fleet46, "joint", 150),
            ("trained_gnn", sim, evaluator, "joint", 50),
            ("plan_bench", cm.FOUR_TASKS, bench, "sequential", 15),
            ("plan_bench", cm.FOUR_TASKS, bench, "joint", 15),
            ("ragged", cm.FOUR_TASKS, ragged, "bucketed", 20),
            ("trained_gnn", sim, evaluator, "scan", 20)]


def phase_gnn_train_graphs(torch, device, card) -> dict:
    """``train_gnn`` on the card (``core/train.py``'s captured programs)
    against the eager loop of the same step functions (its ``_Trainer``
    without capture), per case of ``_train_cases``: each from a fresh
    cache entry (the first call runs each program's first step eagerly and
    captures it), then a second call on the same key, which must capture
    nothing, then the eager loop from the same init. Params and history
    must be equal bit for bit, and ``opt_state.step`` the reference's
    update count. Wall seconds, ms a step, graphs/s, the captures' host
    seconds, and a profiled epoch of replays and of eager steps."""
    from repro_torch.core import gnn
    from repro_torch.core import train as gnn_train

    t0 = time.perf_counter()
    cases = _train_cases()
    labels_s = time.perf_counter() - t0
    out = {}
    for case, tasks, ds, mode, steps in cases:
        cfg = gnn_train.gnn_config_for(tasks)
        d_in = ds[0].feats.shape[1]
        params = gnn.init(cfg, d_in, seed=0, device=device)
        mode_, stacks = gnn_train._resolve_mode(ds, mode)
        opt_cfg = gnn_train._opt_config(0.01)
        key = gnn_train._key(cfg, opt_cfg, mode_, ds, stacks, device)
        gnn_train._TRAINERS.pop(key, None)
        timed = {}
        for call in ("captured", "second"):
            with _capture_clock(torch) as clock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, hist = gnn_train.train_gnn(cfg, ds, steps=steps, lr=0.01,
                                                params=params, mode=mode,
                                                device=device)
                torch.cuda.synchronize()
                timed[call] = (time.perf_counter() - t0, dict(clock))
        trainer = gnn_train._TRAINERS[key]
        eager = gnn_train._Trainer(cfg, opt_cfg, mode_, params, ds, stacks,
                                   device, capture=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_hist = eager.run(steps, ds)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        pairs = list(zip(gnn_train._keyed_leaves(got),
                         gnn_train._keyed_leaves(eager.params)))
        bit_equal = all(torch.equal(a, b) for a, b in pairs)
        max_diff = max(float((a - b).abs().max()) for a, b in pairs)
        updates = steps * (1 if mode_ == "joint" else len(ds))
        step = int(trainer.opt_state.step)
        graphs = len(ds) * steps
        row = {"case": case, "mode": mode_, "graphs": len(ds),
               "buckets": sorted({gnn_train.bucket_for(e.feats.shape[0])
                                  for e in ds}),
               "steps": steps, "updates": updates, "opt_state_step": step,
               "programs": len(trainer.programs),
               "params_bit_equal": bit_equal, "params_max_abs_diff": max_diff,
               "history_equal": hist == eager_hist,
               "final_loss": hist[-1]["loss"],
               "final_accuracy": hist[-1]["accuracy"], "eager_s": eager_s,
               "eager_ms_per_step": eager_s / steps * 1e3,
               "eager_graphs_per_s": graphs / eager_s}
        for call, (wall, clock) in timed.items():
            row.update({f"{call}_s": wall, f"{call}_ms_per_step":
                        wall / steps * 1e3,
                        f"{call}_graphs_per_s": graphs / wall,
                        f"{call}_captures": clock["captures"],
                        f"{call}_capture_s": clock["capture_s"]})
        row["profile_replay"] = _profile_step(torch, trainer, ds)
        row["profile_eager"] = _profile_step(torch, eager, ds)
        emit("gnn_train_graphs", card=card, **row)
        out[f"{case}/{mode_}"] = row
        check(row["captured_captures"] == row["programs"],
              f"{case}/{mode_}: {row['captured_captures']} captures for "
              f"{row['programs']} programs")
        check(row["second_captures"] == 0,
              f"{case}/{mode_}: the second call on one key captured again")
        check(step == updates, f"{case}/{mode_}: opt_state.step {step}, "
              f"want {updates}")
        check(bit_equal and row["history_equal"],
              f"{case}/{mode_}: the captured run differs from the eager "
              f"steps (params by {max_diff})")
        check(math.isfinite(row["final_loss"]), f"{case}/{mode_}: loss")
    emit("gnn_train_graphs_labels", labels_s=labels_s)
    return out


# a token flip between the card and the CPU is a near-tie when the CPU's
# logits of the two tokens are closer than the fp32 kernels-vs-plain logits
# tolerance of the serve phases
TOKEN_FLIP_MARGIN = 2e-4
EXAMPLE_ARGS = {
    "quickstart": [], "geo_placement": [], "simulate_fleet": [],
    "serve_fleet": [], "serve_batch": [],
    "trace_run": ["--time-scale", "0.1", "--out",
                  os.path.join(ROOT, "build", "examples", "trace.json")],
    "train_e2e": ["--steps", "20", "--ckpt-dir",
                  os.path.join(ROOT, "build", "examples", "e2e_ckpt")],
}


def _printed_tokens(lines):
    """The serve_batch twin's generated tokens, from its "  request i: [...]"
    lines, as a (B, gen) array."""
    import numpy as np
    return np.array([json.loads(l.split(": ", 1)[1]) for l in lines
                     if l.startswith("  request ")], np.int64)


def _flip_margins(torch, cfg, params, batch, want, got) -> list:
    """For each row where two generations differ, the first step t where
    they do and the CPU logits' margin there between the two tokens
    (teacher-forced ``forward`` over the prompt and the common prefix)."""
    from repro_torch.models import decoder_lm as dlm
    out = []
    for r in range(want.shape[0]):
        diff = [t for t in range(want.shape[1]) if want[r, t] != got[r, t]]
        if not diff:
            continue
        t = diff[0]
        tokens = torch.cat([torch.as_tensor(batch["tokens"][r:r + 1]),
                            torch.as_tensor(want[r:r + 1, :t])], dim=1)
        with torch.no_grad():
            logits = dlm.forward(params, cfg, tokens=tokens)[0][0, -1].float()
        out.append({"row": r, "step": t, "cpu_token": int(want[r, t]),
                    "card_token": int(got[r, t]),
                    "margin": float(logits[want[r, t]] - logits[got[r, t]])})
    return out


def phase_examples(torch, device, K, FK, DK) -> dict:
    """The seven example twins (``repro_torch.examples``), each through its
    ``main`` in this process on the card, at the reference's defaults
    except ``train_e2e --steps 20`` and ``trace_run --time-scale 0.1``
    (their outputs under the git-ignored build/examples, removed after).
    The evaluator's GNN cache is emptied first, so the fleet twins train
    their own GNNs on the card, with the plain cfgs a user's run has.
    Per twin: seconds, exit, the lines it printed, and the gcn_spmm /
    flash / decode launches, zeroed before and read after. The serve_batch
    twin runs again on the CPU from the card's weights (the plain
    attention): its tokens are compared, and a flip is named with the CPU
    logits' margin between the two tokens."""
    import io

    from repro_torch._tree import tree_map
    from repro_torch.models import common as cc
    from repro_torch.sim import evaluate as ev

    names = ("quickstart", "geo_placement", "simulate_fleet", "serve_fleet",
             "trace_run", "serve_batch", "train_e2e")
    ev._GNN_CACHE.clear()
    scratch = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    weights = {}
    rows, failed = {}, []
    for name in names:
        twin = __import__(f"repro_torch.examples.{name}", fromlist=["main"])
        if name == "serve_batch":
            real = twin.get_api

            def watched_api(cfg, real=real):
                api = real(cfg)

                def init(cfg, seed, device):
                    weights["params"] = api.init_params(cfg, seed=seed,
                                                        device=device)
                    return weights["params"]
                return dataclasses.replace(api, init_params=init)
            twin.get_api = watched_api
        saved = dict(cc.RUNTIME)
        for k in (K, FK, DK):
            k.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                twin.main(EXAMPLE_ARGS[name])
            exit_ = "ok"
        except Exception as e:      # recorded, and the phase fails below
            exit_ = f"{type(e).__name__}: {e}"
            failed.append(name)
        finally:
            seconds = time.perf_counter() - t0
            cc.RUNTIME.clear()
            cc.RUNTIME.update(saved)
            if name == "serve_batch":
                twin.get_api = real
        lines = buf.getvalue().splitlines()
        row = {"twin": name, "seconds": seconds, "exit": exit_,
               "lines": len(lines),
               "launches": {"scaled_spmm": K.LAUNCHES["scaled_spmm"],
                            **dict(FK.LAUNCHES), **dict(DK.LAUNCHES)}}
        if name in ("quickstart", "geo_placement"):
            row["printed"] = lines
        if name == "serve_batch" and exit_ == "ok":
            cpu = tree_map(lambda t: t.cpu(), weights["params"])
            twin.get_api = lambda cfg: dataclasses.replace(
                real(cfg), init_params=lambda cfg, seed, device: cpu)
            cpu_buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(cpu_buf):
                    twin.main(["--device", "cpu"])
            finally:
                twin.get_api = real
                cc.RUNTIME.clear()
                cc.RUNTIME.update(saved)
            from repro_torch.configs import get_config, reduce_for_smoke
            from repro_torch.data.synthetic import SyntheticConfig, make_batch
            cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma3-1b")),
                                      remat=False)
            batch = make_batch(cfg, SyntheticConfig(global_batch=4, seq_len=32,
                                                    seed=0), 0)
            on_card = _printed_tokens(lines)
            on_cpu = _printed_tokens(cpu_buf.getvalue().splitlines())
            row.update(dtype=cfg.dtype, tokens=int(on_card.size),
                       tokens_differ=int((on_card != on_cpu).sum()),
                       flips=_flip_margins(torch, cfg, cpu, batch, on_cpu,
                                           on_card))
        if name == "trace_run":
            row["trace_bytes"] = os.path.getsize(EXAMPLE_ARGS[name][-1])
        if name == "train_e2e":
            row["last_line"] = lines[-1] if lines else None
        emit("examples", **row)
        rows[name] = row
    shutil.rmtree(scratch, ignore_errors=True)
    check(not failed, f"example twins failed: "
          f"{ {n: rows[n]['exit'] for n in failed} }")
    for name in names:
        check(rows[name]["launches"]["scaled_spmm"] == 0,
              f"{name} launched gcn_spmm: its GNNs run the plain cfg")
    served = rows["serve_batch"]["launches"]
    check(served["flash_attention"] > 0 and served["decode_attention"] > 0,
          f"serve_batch twin launches {served}")
    for flip in rows["serve_batch"]["flips"]:
        check(abs(flip["margin"]) < TOKEN_FLIP_MARGIN,
              f"serve_batch: the card's token differs from the CPU's at a "
              f"margin of {flip['margin']}, not a near-tie")
    return rows


MULTI_CARD_TESTS = {
    # test -> the cards it needs: left out (and named) on a machine with fewer
    "tests/test_torch_train_mesh_gpu.py::"
    "test_two_nccl_ranks_match_the_plain_card_loop": 2,
}


def phase_gpu_pytest() -> None:
    """The card-only pytest files (no JAX: they run with --noconftest). A
    test of several NCCL ranks (``MULTI_CARD_TESTS``) is deselected on a
    machine with fewer cards than it needs, and the line names it."""
    import torch
    files = ["tests/test_torch_gcn_spmm_gpu.py", "tests/test_torch_attention_gpu.py",
             "tests/test_torch_serve_gpu.py", "tests/test_torch_flash_backward_gpu.py",
             "tests/test_torch_sim_eval_gpu.py",
             "tests/test_torch_serve_sim_gpu.py",
             "tests/test_torch_families_gpu.py",
             "tests/test_torch_encdec_vlm_gpu.py",
             "tests/test_torch_train_families_gpu.py",
             "tests/test_torch_kernel_dispatch_gpu.py",
             "tests/test_torch_graphs_gpu.py",
             "tests/test_torch_gnn_train_graphs_gpu.py",
             "tests/test_torch_train_mesh_gpu.py",
             "tests/test_torch_head_dims_gpu.py",
             "tests/test_torch_kernel_domain_gpu.py"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cards = torch.cuda.device_count()
    left_out = [t for t, n in MULTI_CARD_TESTS.items() if cards < n]
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                           "-p", "no:cacheprovider", "-q", *files,
                           *(a for t in left_out for a in ("--deselect", t))],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] if proc.stdout else []
    emit("gpu_pytest", files=files, rc=proc.returncode, summary=tail,
         cards=cards, deselected_for_cards=left_out)
    check(proc.returncode == 0 and "skipped" not in " ".join(tail),
          f"card-only pytest failed or skipped:\n{proc.stdout[-3000:]}"
          f"{proc.stderr[-2000:]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the repo")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # The plain versions are the fp32 yardstick: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.kernels.gcn_spmm import ref as R

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.load_all(SOURCES)
    emit("build_all", seconds=time.perf_counter() - t0)
    # the production dry-run runs on the host beside every card phase below
    dry = start_dryrun_production()
    for name in SOURCES:
        info = _build.BUILD_INFO[name]
        emit("build", kernel=name, seconds=info["seconds"],
             ptxas=[l.strip() for l in info["log"].splitlines()
                    if "registers" in l or "spill" in l or "Compiling" in l])
    # 2. gcn_spmm kernel check
    errs = phase_kernel_check(torch, K, R)
    # 3. + 4. the planner's main path, counts zeroed before and read after
    # each plan
    # each through the bucket graphs; every phase's forwards per bucket
    # (calls, traces, cache hits) on a "jit" line
    with jit_counts("fleet46_plan"):
        params46, cfg46, fleet46, l46 = phase_fleet46(torch, device)
    with jit_counts("plan_1024"):
        fleet1024, l1024, params1024, kcfg1024 = phase_1024(torch, device)
    launches = {k: l46[k] + l1024[k] for k in l46}
    # 4b. elastic recovery on the 1024-node fleet, counts zeroed before and
    # read after each event; then the simulator's core on its survivors
    with jit_counts("recover_1024"):
        l_recover, joined, (survivors, recovered) = phase_recover_1024(
            torch, device, params1024, kcfg1024, fleet1024)
    phase_net_1024(survivors, recovered)
    # 4c. the fleet evaluation, the online controller and the 1024-node
    # simulation, their Hulk GNNs aggregating through scaled_spmm; counts
    # zeroed before and read after each run
    l_sim = {}
    for name, run in (
            ("sim_scenarios", lambda: phase_sim_scenarios(device)),
            ("drift_controller", phase_drift_controller),
            ("sim_1024", lambda: phase_sim_1024(params1024, kcfg1024)),
            # 4d. GNN-placed serving, colocation, the chaos suites and
            # serving at 1024 nodes
            ("serve_scenarios", lambda: phase_serve_scenarios(device)),
            ("colocated", lambda: phase_colocated(device)),
            ("chaos", phase_chaos),
            ("serve_1024", lambda: phase_serve_1024(device))):
        with jit_counts(name):
            l_sim[name] = run()
    # 5. gcn_spmm times
    card = card_identity()
    from repro_torch.sim import scenarios as sc
    times = phase_times(torch, K, R, params46, cfg46,
                        {8: sc.get_scenario("cross_region_wan").fleet(0),
                         16: sc.get_scenario("preemption_storm").fleet(0),
                         64: fleet46, 1024: fleet1024, 2048: joined}, device,
                        card)
    # 5b. predict_logits through the bucket graphs against the eager paths
    phase_gnn_graphs(torch, device, params46, cfg46,
                     {64: fleet46, 1024: fleet1024, 2048: joined}, card)
    # 6. attention kernel check, then every head dim up to 256 (forward,
    # backward, decode; one profiled call each; force_ref on the card)
    errs.update(phase_attention_check(torch, FK, FR, DK, DR))
    hd_errs = phase_head_dims(torch, FK, FR, DK, DR)
    # 6b. every input the reference's kernels take: head dims past 256,
    # fp16, views, mixed adjacency dtypes, rows that see no key
    domain = phase_kernel_domain(torch, FK, FR, DK, DR)
    # 6c. the flash backward: check and times at the training shape (here,
    # while the card's profiler still keeps its records for the split)
    bwd_errs = phase_flash_bwd_check(torch, FK, FR)
    bwd_times = phase_flash_bwd_times(torch, FK, FR, card)
    # 7. the serving main path, counts zeroed before and read after
    launches.update(phase_serve(torch, device, FK, DK))
    # 7b. the MoE, MLA, Mamba and xLSTM families: olmoe-1b-7b at full width,
    # deepseek-v2 at full width and 2 layers, jamba and xlstm reduced and
    # xlstm at full size; counts zeroed before and read after each serve
    l_olmoe = phase_serve_olmoe(torch, device, FK, DK)
    phase_serve_deepseek_v2(torch, device, FK, DK)
    l_small = phase_serve_families_small(torch, device, FK, DK)
    # 7c. the encoder-decoder and VLM families at full width: whisper-small
    # (flash on the decoder's 12 layers, G 1) and internvl2-1b (G 7); counts
    # zeroed before and read after each serve
    l_family = {"serve_whisper_small": phase_serve_whisper_small(
                    torch, device, FK, DK),
                "serve_internvl2_1b": phase_serve_internvl2_1b(
                    torch, device, FK, DK),
                # phi3-mini at full width: head_dim 96 read unpadded
                "serve_phi3_mini": phase_serve_phi3_mini(torch, device, FK, DK)}
    # 8. attention times at the serve shapes
    attn_times = phase_attention_times(torch, FK, FR, DK, DR, card)
    # 10. the training main path, counts zeroed before and read after
    train_launches = phase_train(torch, device, FK, card)
    # 10a. the same training on a one-card NCCL device mesh, counts zeroed
    # before and read after
    mesh_launches = phase_train_mesh_1card(torch, device, FK, card)
    # 10b. the cost and layout tools: the pricer and the one-card dry-run
    # held to what the serve and train phases held on the card, the
    # production dry-run (host only), the one-card NCCL mesh
    phase_price_serve(card)
    phase_dryrun_1chip(card)
    phase_dryrun_production(dry, card)
    phase_mesh_1card(torch, device)
    # 10c. the GNN trainer's captured programs against its eager steps, and
    # the seven example twins as a user runs them, launches zeroed before
    # and read after each twin
    phase_gnn_train_graphs(torch, device, card)
    l_examples = phase_examples(torch, device, K, FK, DK)
    # 11. the card-only pytest files
    phase_gpu_pytest()
    # 12. kernels summary. gcn_spmm: headline at bucket 1024, the largest
    # a plan of the 1024-node fleet runs (the join's 2048 is in by_bucket).
    # Attention: headline at the global layer (the most work per launch),
    # every serve shape in by_case.
    replaces = {"scaled_spmm": "src/repro/kernels/gcn_spmm/kernel.py:87",
                "spmm": "src/repro/kernels/gcn_spmm/kernel.py:43"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    decode_keys = ("ms_graphed", "library_ms_graphed", "ms_cold", "library_ms_cold")
    kernels = []
    for name in ("scaled_spmm", "spmm"):
        top = times[name][1024]
        recover = sum(l_recover.values()) if name == "scaled_spmm" else 0
        by_path = {"plan": launches[name], "recover": recover,
                   **{k: n if name == "scaled_spmm" else 0
                      for k, n in l_sim.items()},
                   "kernel_domain": domain["launches"].get(name, 0)}
        kernels.append({
            "name": f"gcn_spmm.{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/gcn_spmm.cu",
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "on_main_path": name == "scaled_spmm",
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "max_abs_err_kernel_domain": domain["errs"][name],
            **{k: top[k] for k in keys},
            "by_bucket": {str(b): times[name][b] for b in TIMED_BUCKETS}})
    for name in ("flash_attention", "decode_attention"):
        by_path = {"serve": launches[name], "serve_olmoe": l_olmoe[name],
                   **{f"serve {k}": n[name] for k, n in l_small.items()},
                   **{k: n[name] for k, n in l_family.items()},
                   **{f"examples {k}": r["launches"][name]
                      for k, r in l_examples.items()
                      if r["launches"][name]}}
        if name == "flash_attention":
            by_path["train"] = train_launches[name]
            by_path["train_mesh_1card"] = mesh_launches[name]
        by_path["kernel_domain"] = domain["launches"].get(name, 0)
        kernels.append({
            "name": f"{name}.{name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": ATTN_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "on_main_path": True,
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "max_abs_err_head_dims": hd_errs[
                "forward" if name == "flash_attention" else "decode"],
            "max_abs_err_kernel_domain": domain["errs"][
                "forward" if name == "flash_attention" else "decode"],
            **{k: attn_times[name]["global"][k] for k in keys},
            **{k: attn_times[name]["global"][k] for k in decode_keys
               if k in attn_times[name]["global"]},
            "by_case": attn_times[name]})
    kernels.append({
        "name": "flash_attention.flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": BWD_REPLACES, "replaces_note": "the gradient of that "
        "kernel's function (the reference differentiates its plain oracle)",
        "launches": train_launches["flash_attention_bwd"]
        + mesh_launches["flash_attention_bwd"]
        + domain["launches"].get("flash_attention_bwd", 0),
        "launches_by_path": {
            "train": train_launches["flash_attention_bwd"],
            "train_mesh_1card": mesh_launches["flash_attention_bwd"],
            "kernel_domain": domain["launches"].get("flash_attention_bwd", 0)},
        "on_main_path": True,
        "max_abs_err": bwd_errs["float32"], "max_abs_err_bf16": bwd_errs["bfloat16"],
        "max_abs_err_head_dims": hd_errs["backward"],
        "max_abs_err_kernel_domain": domain["errs"]["backward"],
        **{k: bwd_times["global"][k] for k in keys}, "by_case": bwd_times})
    # 13. import check
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    check(not bad, f"the port loaded JAX or the reference package: {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
