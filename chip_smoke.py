"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels (``gcn_spmm``, ``flash_attention``,
``decode_attention``) from ``src/repro_torch/csrc`` with nvcc, one process
per source, and checks each against its plain PyTorch version. Then it
drives both main paths through the port's entry points at full width: the
planner (hidden 213, two GCN layers) on fleet46 and a 1024-node fleet, and
serving gemma3-1b (26 layers, d_model 1152, bf16, random weights from a
seed) on 4 prompts of 1024 tokens with 64 generated. It times every kernel
beside its plain version, a one-call library yardstick and its bound, runs
the card-only pytest files, and prints one JSON line per phase. Any failure
exits non-zero before the last line, which is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX or ``repro``.

Phases: build -> kernel check (gcn_spmm) -> fleet46 plan (paper Table 2 /
Fig. 8) -> 1024-node plan -> gcn_spmm times and a bit-for-bit repeat at
bucket 1024 -> kernel check (attention) ->
gemma3-1b serve -> attention times -> card-only pytest -> kernels summary
-> import check.
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
            valid = AG.ring_mask(t, 3 * t + 7, 3 * t - 100) if mask == "ring" \
                else (np.arange(t) < mask).astype(np.int32)
            valid = torch.from_numpy(valid).cuda()
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
    """Device busy share and the top device ops over ``steps`` decode steps
    (torch.profiler, CUDA activity), after a fresh prefill."""
    from torch.profiler import ProfilerActivity, profile
    s = tokens.shape[1]
    with torch.no_grad():
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
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "cpu_events_per_step": sum(e.count for e in events
                                       if e not in kernels) / steps,
            "top_kernels": [[e.key[:100], _dev_time(e) / steps, e.count / steps]
                            for e in top]}


def phase_serve(torch, device, FK, DK) -> dict:
    """gemma3-1b at full width, bf16, random weights from a seeded generator,
    through the port's ``serve_batch`` (which turns ``use_flash`` on), after
    one short warm-up call. Then the same weights teacher-forced on the
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

    FK.reset_launches()
    DK.reset_launches()
    gen, stats = serve.serve_batch(cfg, params, batch, gen_n, log=lambda *_: None)
    launches = {"flash_attention": FK.LAUNCHES["flash_attention"],
                "decode_attention": DK.LAUNCHES["decode_attention"]}
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.n_layers
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * (gen_n - 1)},
          f"serve launches {launches}, want {n_layers} flash and "
          f"{n_layers * (gen_n - 1)} decode")
    check(gen.shape == (b, gen_n) and ((gen >= 0) & (gen < cfg.vocab_size)).all(),
          f"generated tokens of shape {gen.shape} out of range")
    tokens = torch.as_tensor(batch["tokens"], device=device)
    fed = torch.as_tensor(gen, device=device)
    prof = _profile_decode(torch, dlm, params, cfg, tokens, fed, max_len)
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
         peak_mem_bytes=peak, launches=launches,
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
    # the profiler slows the host: the idle share of an unprofiled step
    step_ms = stats["decode_s"] * 1e3 / stats["decode_steps"]
    prof["unprofiled_ms_per_step"] = step_ms
    prof["device_idle_share_unprofiled"] = \
        1.0 - prof["device_busy_ms_per_step"] / step_ms
    emit("serve_profile", **prof)
    check(ok32_prefill, f"fp32 prefill logits with the kernels differ from "
                        f"the plain path by {err32_prefill}")
    check(ok32_decode, f"fp32 teacher-forced decode logits with the kernels "
                       f"differ from the plain path by {err32_decode}")
    return launches


def _attn_time_cases(torch, F, FK, FR, DK, DR):
    """The serve shapes: prefill of a global (causal) and a local (window
    512) layer, and one decode step of the global cache (T 1088, valid up
    to the middle of generation) and of a local ring (T 512, all valid)."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE["arch"])
    spec_local = cfg.segments[0].layers[0].attn
    h, kvh, d = spec_local.n_heads, spec_local.n_kv_heads, spec_local.head_dim
    b, s = SERVE["batch"], SERVE["prompt"]
    max_len = s + SERVE["gen"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    elt = 2
    cases = {}
    for label, window in (("global", None), ("local", spec_local.window)):
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
    for label, t, n_valid in (("global", max_len, s + SERVE["gen"] // 2),
                              ("local", spec_local.window, spec_local.window)):
        q, k, v = rn(b, 1, h, d), rn(b, t, kvh, d), rn(b, t, kvh, d)
        valid = (torch.arange(t, device="cuda") < n_valid).to(torch.int32)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        cases[("decode_attention", label)] = dict(
            shape=dict(B=b, T=t, H=h, KV=kvh, D=d, valid=n_valid),
            kernel=lambda q=q, k=k, v=v, m=valid: DK.decode_attention(q, k, v, m),
            plain=lambda q=q, k=k, v=v, m=valid: DR.decode_attention_ref(q, k, v, m),
            library=lambda qt=qt, kt=kt, vt=vt, m=valid > 0: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m[None, :], enable_gqa=True),
            # the valid slots' K/V, the query, the mask and the output
            nbytes=(2 * b * n_valid * kvh * d + 2 * q.numel()) * elt + 4 * t,
            flops=4 * d * n_valid * b * h)
    return cases


def phase_attention_times(torch, FK, FR, DK, DR, card) -> dict:
    """Kernel, plain version, SDPA yardstick (timed only, never used by the
    port) and bound, at the serve shapes, bf16."""
    import torch.nn.functional as F
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
        emit("times", kernel=name, card=card, **_shares(row))
        out.setdefault(name, {})[label] = row
    return out


def phase_gpu_pytest() -> None:
    """The card-only pytest files (no JAX: they run with --noconftest)."""
    files = ["tests/test_torch_gcn_spmm_gpu.py", "tests/test_torch_attention_gpu.py"]
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
    # 9. the card-only pytest files
    phase_gpu_pytest()
    # 10. kernels summary. gcn_spmm: headline at bucket 1024, the largest
    # the planner runs. Attention: headline at the global layer (the most
    # work per launch), every serve shape in by_case.
    replaces = {"scaled_spmm": "src/repro/kernels/gcn_spmm/kernel.py:87",
                "spmm": "src/repro/kernels/gcn_spmm/kernel.py:43"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
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
            "by_case": attn_times[name]})
    # 11. import check
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
