"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels (``gcn_spmm``, ``flash_attention``
with its backward ``flash_attention_bwd``, ``decode_attention``) from
``src/repro_torch/csrc`` with nvcc, one process per source, and checks each
against its plain PyTorch version. Then it drives the three main paths
through the port's entry points at full width: the planner (hidden 213, two
GCN layers) on fleet46 and a 1024-node fleet; serving gemma3-1b (26 layers,
d_model 1152, bf16, random weights from a seed) on 4 prompts of 1024 tokens
with 64 generated, whose decode loop replays one captured CUDA graph of the
decode step; and training the same model (batch 4 x 1024 tokens, remat on,
chunked CE) for 6 steps through ``launch/train.py::train_loop`` with a
checkpoint every 3 steps, then a fresh loop that resumes from step 3. It
times every kernel beside its plain version, a one-call library yardstick
and its bound (the attention kernels also at phi3-mini's head_dim 96, the
backward also split by kernel), runs the card-only pytest files, and prints
one JSON line per phase. Any failure exits non-zero before the last line,
which is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
``repro``.

Phases: build -> kernel check (gcn_spmm) -> fleet46 plan (paper Table 2 /
Fig. 8) -> 1024-node plan -> gcn_spmm times and a bit-for-bit repeat at
bucket 1024 -> kernel check (attention) -> gemma3-1b serve (launch counts,
a repeat call that must hold no more memory, the graphed step against the
eager one, eager and graphed decode profiles, kernels vs plain in fp32) ->
attention times (decode also per call inside a graph and from HBM) ->
kernel check (flash backward) -> flash backward times -> gemma3-1b train
(launch counts, the resumed losses against the straight run's, a profile
of one step) -> card-only pytest -> kernels summary -> import check.

Launch counts on the serve path, zeroed just before the 64-token call and
read just after it: 26 ``flash_attention`` (one prefill of 26 layers) and
26 x 64 = 1,664 ``decode_attention``: the eager warm-up step before the
capture (26), then 63 replays of a graph that holds one step (26 each);
the capture itself runs nothing. On the train path, zeroed just before
the 6 straight steps and read just after: 26 x 2 x 6 = 312
``flash_attention`` (each layer's forward and its recompute under remat)
and 26 x 6 = 156 ``flash_attention_bwd``.
"""
from __future__ import annotations

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
    main path's buckets 64 (paper_fleet46) and 1024 (random_fleet(1024)).
    At bucket 1024 (split-K over a cluster) two kernel calls must agree bit
    for bit."""
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
            emit("times", kernel=name, card=card, **_shares(row))
            out.setdefault(name, {})[b] = row
            if b == 1024:   # split-K over a cluster: no atomics, same bits
                first, second = c["kernel"](), c["kernel"]()
                torch.cuda.synchronize()
                same = torch.equal(first, second)
                emit("determinism", kernel=name, bucket=b, bit_identical=same)
                check(same, f"two {name} calls at bucket {b} differ")
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


def _dev_time(e) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def _profile_prefill(torch, dlm, params, cfg, tokens, max_len, repeats=5) -> dict:
    """Median host wall time of ``repeats`` warm prefills (each ended by a
    synchronize), then one prefill under torch.profiler (CUDA activity):
    the device time of its kernels, the flash kernel's part of it and the
    largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    with torch.no_grad():
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_dev_time(e) for e in kernels)
    flash_us = sum(_dev_time(e) for e in kernels if "flash_" in e.key)
    top = sorted(kernels, key=_dev_time, reverse=True)[:6]
    wall = statistics.median(walls)
    return {"repeats": repeats, "wall_ms_median": wall * 1e3,
            "wall_ms": [w * 1e3 for w in walls],
            "tokens_per_s_median": tokens.numel() / wall,
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


def _graph_vs_eager(torch, dlm, serve, params, cfg, tokens, fed, gen, max_len,
                    steps=8) -> dict:
    """The captured step against the eager one on the same weights and the
    same prefill caches: ``decode_step`` captured with a tensor pos and
    replayed teacher-forced on ``fed`` against eager ``decode_step`` calls
    (logits, bit for bit expected: the same kernels in the same order), and
    ``serve_batch``'s graphed tokens ``gen`` against an eager greedy loop
    of ``make_decode_step``'s step."""
    from repro_torch.training.train_step import make_decode_step
    s = tokens.shape[1]

    def clone(tree):   # caches: lists of per-layer dicts of tensors
        return [{k: v.clone() for k, v in c.items()} if isinstance(c, dict)
                else clone(c) for c in tree]

    with torch.no_grad():
        last, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
        eager_caches = clone(caches)
        tok = fed[:, :1].clone()
        pos = torch.full((), s, dtype=torch.int32, device=tokens.device)
        dlm.decode_step(params, cfg, tok, pos, clone(caches))   # eager warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = dlm.decode_step(params, cfg, tok, pos, caches)
        errs, same = [], True
        for i in range(steps):
            tok.copy_(fed[:, i:i + 1])
            pos.fill_(s + i)
            graph.replay()
            want, eager_caches = dlm.decode_step(params, cfg, fed[:, i:i + 1],
                                                 s + i, eager_caches)
            torch.cuda.synchronize()
            same = same and torch.equal(logits, want)
            errs.append((logits - want).abs().max().item())
        graph.reset()
        del graph, logits, caches, eager_caches
        step = make_decode_step(cfg)
        _, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
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


def _profile_decode_graph(torch, dlm, serve, params, cfg, tokens, max_len, DK,
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
    from repro_torch.training.train_step import make_decode_step
    s = tokens.shape[1]
    step = make_decode_step(cfg)

    def prefilled():
        last, caches = dlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlm.init_params(cfg, seed=SERVE["seed"], device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = make_batch(cfg, SyntheticConfig(global_batch=b, seq_len=s,
                                            seed=SERVE["seed"]), 0)
    _, cold = serve.serve_batch(cfg, params, batch, 2, log=lambda *_: None)
    torch.cuda.synchronize()
    allocated = [torch.cuda.memory_allocated()]

    FK.reset_launches()
    DK.reset_launches()
    gen, stats = serve.serve_batch(cfg, params, batch, gen_n, log=lambda *_: None)
    launches = {"flash_attention": FK.LAUNCHES["flash_attention"],
                "decode_attention": DK.LAUNCHES["decode_attention"]}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    allocated.append(torch.cuda.memory_allocated())
    n_layers = cfg.n_layers
    # one eager warm-up step before the capture, then gen_n - 1 replays of a
    # graph that holds one step: n_layers decode launches per step, gen_n
    # steps' worth; the capture itself launches nothing
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * gen_n},
          f"serve launches {launches}, want {n_layers} flash and "
          f"{n_layers * gen_n} decode")
    check(gen.shape == (b, gen_n) and ((gen >= 0) & (gen < cfg.vocab_size)).all(),
          f"generated tokens of shape {gen.shape} out of range")
    # a repeat call: the graph and its pool are released, memory does not grow
    torch.cuda.reset_peak_memory_stats()
    gen_again, stats_again = serve.serve_batch(cfg, params, batch, gen_n,
                                               log=lambda *_: None)
    peak_again = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    allocated.append(torch.cuda.memory_allocated())
    check(max(allocated[1:]) <= allocated[0],
          f"device memory after serve calls grows: {allocated}")
    check((gen_again == gen).all(), "a repeat serve call generated other tokens")
    tokens = torch.as_tensor(batch["tokens"], device=device)
    fed = torch.as_tensor(gen, device=device)
    g_vs_e = _graph_vs_eager(torch, dlm, serve, params, cfg, tokens, fed, gen,
                             max_len)
    emit("serve_graph_vs_eager", **g_vs_e)
    check(g_vs_e["tokens_equal"], "graphed serve tokens differ from the eager "
                                  "greedy loop's")
    check(g_vs_e["logits_bit_identical"] or g_vs_e["logits_max_abs_err"] <= 2e-2,
          f"graphed decode logits differ from eager ones by "
          f"{g_vs_e['logits_max_abs_err']}")
    prof = _profile_decode(torch, dlm, params, cfg, tokens, fed, max_len)
    gprof = _profile_decode_graph(torch, dlm, serve, params, cfg, tokens, max_len,
                                  DK)
    emit("serve_prefill_profile",
         **_profile_prefill(torch, dlm, params, cfg, tokens, max_len))

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
         decode_s=stats["decode_s"], cold_prefill_s=cold["prefill_s"],
         decode_capture_s=stats["decode_capture_s"],
         repeat_call={k: stats_again[k] for k in (
             "prefill_tokens_per_s", "tokens_per_s", "decode_capture_s")},
         peak_mem_bytes=peak, peak_mem_bytes_repeat_call=peak_again,
         allocated_bytes_after_calls=allocated, launches=launches,
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


def _attn_time_cases(torch, F, FK, FR, DK, DR):
    """The serve shapes: prefill of a global (causal) and a local (window
    512) layer, and one decode step of the global cache (T 1088, valid up
    to the middle of generation) and of a local ring (T 512, all valid);
    and phi3-mini's attention (32 heads, 32 kv heads, head_dim 96, which
    the wrappers pad to 128): a prefill of 1 x 1024 tokens and a decode
    step at B 4 against T 1088."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE["arch"])
    spec_local = cfg.segments[0].layers[0].attn
    phi3 = get_config("phi3-mini-3.8b").segments[0].layers[0].attn
    b, s = SERVE["batch"], SERVE["prompt"]
    max_len = s + SERVE["gen"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    elt = 2
    cases = {}
    gemma = (spec_local.n_heads, spec_local.n_kv_heads, spec_local.head_dim)
    phi = (phi3.n_heads, phi3.n_kv_heads, phi3.head_dim)
    for label, window, b, (h, kvh, d) in (
            ("global", None, SERVE["batch"], gemma),
            ("local", spec_local.window, SERVE["batch"], gemma),
            ("phi3-mini", None, 1, phi)):
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
            kernel=lambda q=q, k=k, v=v, w=window: FK.flash_attention(q, k, v, window=w),
            plain=lambda q=q, k=k, v=v, w=window: FR.attention_ref(q, k, v, window=w),
            library=lambda qt=qt, kt=kt, vt=vt, m=mask: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True),
            nbytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
            flops=4 * d * pairs * b * h)
    b = SERVE["batch"]
    for label, t, n_valid, (h, kvh, d) in (
            ("global", max_len, s + SERVE["gen"] // 2, gemma),
            ("local", spec_local.window, spec_local.window, gemma),
            ("phi3-mini", max_len, s + SERVE["gen"] // 2, phi)):
        q, k, v = rn(b, 1, h, d), rn(b, t, kvh, d), rn(b, t, kvh, d)
        valid = torch.arange(t, device="cuda") < n_valid
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        cases[("decode_attention", label)] = dict(
            shape=dict(B=b, T=t, H=h, KV=kvh, D=d, valid=n_valid),
            kernel=lambda q=q, k=k, v=v, m=valid: DK.decode_attention(q, k, v, m),
            plain=lambda q=q, k=k, v=v, m=valid: DR.decode_attention_ref(q, k, v, m),
            library=lambda qt=qt, kt=kt, vt=vt, m=valid: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m[None, :], enable_gqa=True),
            # the valid slots' K/V, the query, the bool mask and the output
            nbytes=(2 * b * n_valid * kvh * d + 2 * q.numel()) * elt + t,
            flops=4 * d * n_valid * b * h)
    return cases


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
        row = {"layer": label, **c["shape"], "dtype": "bfloat16",
               "ms": _time_ms(torch, c["kernel"]),
               "plain_ms": _time_ms(torch, c["plain"]),
               "library_ms": _time_ms(torch, c["library"]),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": c["nbytes"], "flops": c["flops"]}
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


def _kernel_split_ms(torch, fn, names, calls=5) -> dict:
    """Device ms of one call of ``fn`` by kernel, from torch.profiler over
    ``calls`` calls: the kernels whose names contain each of ``names``, and
    the call's other device time under "other"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    split = {n: sum(_dev_time(e) for e in kernels if n in e.key) / 1e3 / calls
             for n in names}
    total = sum(_dev_time(e) for e in kernels) / 1e3 / calls
    split["other"] = total - sum(split.values())
    return split


def phase_flash_bwd_times(torch, FK, FR, card) -> dict:
    """The backward at gemma3-1b's training shape (B 4, S 1024, H 4, KV 1,
    D 256, bf16), global and window 512, and at phi3-mini's attention (B 1,
    S 1024, H 32, KV 32, D 96 run at width 128, causal): kernel (one call:
    prep, dK/dV, dQ and, when H > KV, the sum of the heads' partials), the
    same call's device time by kernel from a profile (``split_ms``), its
    plain version (``attention_bwd_ref``: the same function from the same o
    and log-sum-exp), and one SDPA forward + backward as the library
    yardstick (timed only, never used by the port; causal flag for the
    global layers, a boolean mask for the window). Bound: bytes (q, k, v, o,
    dO and the log-sum-exp read, dq, dk, dv written) / 3.35 TB/s against
    the backward's five products over the visible pairs (S, dP, dV, dK, dQ:
    10 D flops a pair and head, at the true D) / 989 TFLOP/s."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    spec = get_config(TRAIN["arch"]).segments[0].layers[0].attn
    phi3 = get_config("phi3-mini-3.8b").segments[0].layers[0].attn
    gemma = (TRAIN["batch"], spec.n_heads, spec.n_kv_heads, spec.head_dim)
    phi = (1, phi3.n_heads, phi3.n_kv_heads, phi3.head_dim)
    s = TRAIN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    out = {}
    for label, window, (b, h, kvh, d) in (("global", None, gemma),
                                          ("local", spec.window, gemma),
                                          ("phi3-mini", None, phi)):
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
        row = {"layer": label, "B": b, "S": s, "H": h, "KV": kvh, "D": d,
               "window": window, "dtype": "bfloat16",
               "ms": _time_ms(torch, kernel),
               "split_ms": _kernel_split_ms(torch, kernel, BWD_KERNELS),
               "plain_ms": _time_ms(torch, lambda: FR.attention_bwd_ref(
                   q, k, v, o, lse, do, window=window)),
               "library_ms": _time_ms(torch, library),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        emit("times", kernel="flash_attention_bwd", card=card, **_shares(row))
        out[label] = row
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
    run's at tests/test_train_resume.py's rtol 1e-5 / atol 1e-6. Launch
    counts of the straight run, step times (each step's own wall time:
    ``log_every`` 1 reads its metrics on the host), tokens/s, peak device
    memory, and a profile of one more step."""
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
        prof = _profile_train_step(torch, make_train_step(cfg, opt_cfg), state, batch)
    finally:
        cc.RUNTIME.update(saved)
    del state
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    step_ms = [h["step_s"] * 1e3 for h in straight]
    warm_ms = statistics.median(step_ms[1:])
    emit("train", arch=TRAIN["arch"], dtype=cfg.dtype, layers=n_layers,
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
    emit("train_profile", card=card, **prof)
    check(resume_ok, f"resumed losses differ from the straight run's: {loss_err}")
    return launches


def phase_gpu_pytest() -> None:
    """The card-only pytest files (no JAX: they run with --noconftest)."""
    files = ["tests/test_torch_gcn_spmm_gpu.py", "tests/test_torch_attention_gpu.py",
             "tests/test_torch_serve_gpu.py", "tests/test_torch_flash_backward_gpu.py"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                           "-p", "no:cacheprovider", "-q", *files],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] if proc.stdout else []
    emit("gpu_pytest", files=files, rc=proc.returncode, summary=tail)
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
    for name in SOURCES:
        info = _build.BUILD_INFO[name]
        emit("build", kernel=name, seconds=info["seconds"],
             ptxas=[l.strip() for l in info["log"].splitlines()
                    if "registers" in l or "spill" in l or "Compiling" in l])
    # 2. gcn_spmm kernel check
    errs = phase_kernel_check(torch, K, R)
    # 3. + 4. the planner's main path, counts zeroed before and read after
    # each plan
    params46, cfg46, fleet46, l46 = phase_fleet46(torch, device)
    fleet1024, l1024 = phase_1024(torch, device)
    launches = {k: l46[k] + l1024[k] for k in l46}
    # 5. gcn_spmm times
    card = card_identity()
    times = phase_times(torch, K, R, params46, cfg46,
                        {64: fleet46, 1024: fleet1024}, device, card)
    # 6. attention kernel check
    errs.update(phase_attention_check(torch, FK, FR, DK, DR))
    # 7. the serving main path, counts zeroed before and read after
    launches.update(phase_serve(torch, device, FK, DK))
    # 8. attention times at the serve shapes
    attn_times = phase_attention_times(torch, FK, FR, DK, DR, card)
    # 9. the flash backward: check and times at the training shape
    bwd_errs = phase_flash_bwd_check(torch, FK, FR)
    bwd_times = phase_flash_bwd_times(torch, FK, FR, card)
    # 10. the training main path, counts zeroed before and read after
    train_launches = phase_train(torch, device, FK, card)
    # 11. the card-only pytest files
    phase_gpu_pytest()
    # 12. kernels summary. gcn_spmm: headline at bucket 1024, the largest
    # the planner runs. Attention: headline at the global layer (the most
    # work per launch), every serve shape in by_case.
    replaces = {"scaled_spmm": "src/repro/kernels/gcn_spmm/kernel.py:87",
                "spmm": "src/repro/kernels/gcn_spmm/kernel.py:43"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    decode_keys = ("ms_graphed", "library_ms_graphed", "ms_cold", "library_ms_cold")
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
            **{k: top[k] for k in keys},
            "by_bucket": {str(b): times[name][b] for b in TIMED_BUCKETS}})
    for name in ("flash_attention", "decode_attention"):
        kernels.append({
            "name": f"{name}.{name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": ATTN_REPLACES[name], "launches": launches[name],
            "on_main_path": True,
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            **{k: attn_times[name]["global"][k] for k in keys},
            **{k: attn_times[name]["global"][k] for k in decode_keys
               if k in attn_times[name]["global"]},
            "by_case": attn_times[name]})
    kernels[-2]["launches"] += train_launches["flash_attention"]
    kernels[-2]["launches_by_path"] = {
        "serve": launches["flash_attention"],
        "train": train_launches["flash_attention"]}
    kernels.append({
        "name": "flash_attention.flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": BWD_REPLACES, "replaces_note": "the gradient of that "
        "kernel's function (the reference differentiates its plain oracle)",
        "launches": train_launches["flash_attention_bwd"], "on_main_path": True,
        "max_abs_err": bwd_errs["float32"], "max_abs_err_bf16": bwd_errs["bfloat16"],
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
