"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernel of ``gcn_spmm`` from
``src/repro_torch/csrc`` with nvcc, checks it against its plain PyTorch
version, drives the planner's main path at full width (hidden 213, two GCN
layers) through the port's entry points, times the kernel, and prints one
JSON line per phase. Any failure exits non-zero before the last line, which
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.

Phases: build -> kernel check -> fleet46 plan (paper Table 2 / Fig. 8) ->
1024-node plan -> kernel times -> kernels summary -> import check.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

CHECK_SHAPES = [(8, 22, "float32"), (46, 15, "float32"), (64, 213, "float32"),
                (128, 213, "float32"), (200, 64, "float32"),
                (1024, 213, "float32"), (46, 12, "bfloat16")]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol
TIMED_BUCKETS = (64, 1024)
N_TIMED = 60


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def plan_invariants(graph, assignment, tasks) -> None:
    mem = graph.memory_gb()
    by_name = {t.name: t for t in tasks}
    all_ids = [i for ids in assignment.groups.values() for i in ids]
    check(len(all_ids) == len(set(all_ids)), "groups are not disjoint")
    for name, ids in assignment.groups.items():
        check(sum(mem[i] for i in ids) >= by_name[name].min_memory_gb,
              f"group of {name} misses its memory threshold")


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
            err = (got - want).abs().max().item()
            ok = bool(torch.all((got - want).abs() <= tol + tol * want.abs()))
            emit("kernel_check", kernel=name, n=n, d=d, dtype=dt_name,
                 max_abs_err=err, max_abs_ref=want.abs().max().item(),
                 rtol=tol, atol=tol, ok=ok)
            check(bool(torch.isfinite(got).all()), f"{name} gave non-finite values")
            check(ok, f"{name} disagrees with its plain version at "
                      f"({n}, {d}, {dt_name}): max abs err {err}")
            errs[name][dt_name] = max(errs[name].get(dt_name, 0.0), err)
    return errs


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
    plain = gnn_train.predict_logits(params, cfg, fleet, device=device)
    fused = gnn_train.predict_logits(params, kcfg, fleet, device=device)
    check(plain.shape == (fleet.n, cfg.n_classes), "logits have the wrong shape")
    check(bool((abs(fused - plain) <= 1e-5 + 1e-5 * abs(plain)).all()),
          "use_pallas logits disagree with the plain path")

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
         logits_max_abs_diff_fused_vs_plain=float(abs(fused - plain).max()),
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
    return fleet, launches


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


def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_times(torch, K, R, params, cfg, graphs, device, card) -> dict:
    """Kernel, plain version, one-library-call yardstick and bound, at the
    main path's buckets 64 (paper_fleet46) and 1024 (random_fleet(1024))."""
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
            emit("times", kernel=name, card=card, **row)
            out.setdefault(name, {})[b] = row
    return out


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
    from repro_torch.kernels.gcn_spmm import kernel as K
    from repro_torch.kernels.gcn_spmm import ref as R

    # 1. build
    _build.load("gcn_spmm")
    info = _build.BUILD_INFO["gcn_spmm"]
    emit("build", kernel="gcn_spmm", seconds=info["seconds"],
         ptxas=[l.strip() for l in info["log"].splitlines()
                if "registers" in l or "spill" in l])
    # 2. kernel check
    errs = phase_kernel_check(torch, K, R)
    # 3. + 4. the main path, counts zeroed before and read after each plan
    params46, cfg46, fleet46, l46 = phase_fleet46(torch, device)
    fleet1024, l1024 = phase_1024(torch, device)
    launches = {k: l46[k] + l1024[k] for k in l46}
    # 5. times
    card = card_identity()
    times = phase_times(torch, K, R, params46, cfg46,
                        {64: fleet46, 1024: fleet1024}, device, card)
    # 6. kernels summary: headline times at bucket 1024, the largest the
    # planner runs; both buckets in by_bucket
    replaces = {"scaled_spmm": "src/repro/kernels/gcn_spmm/kernel.py:87",
                "spmm": "src/repro/kernels/gcn_spmm/kernel.py:43"}
    kernels = []
    for name in ("scaled_spmm", "spmm"):
        top = times[name][1024]
        kernels.append({
            "name": f"gcn_spmm.{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/gcn_spmm.cu",
            "replaces": replaces[name], "launches": launches[name],
            "on_main_path": name == "scaled_spmm",
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "by_bucket": {str(b): times[name][b] for b in TIMED_BUCKETS}})
    # 7. import check
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
