"""The readings that the limits of an MLA + MoE serving cell
(``bench/limits/<cell>.json``, kind ``serve_moe``) are set from, one
process for many seeds (not run by the benchmark's own runs). The kind's
own check (``compare`` of ``bench/kinds/serve_moe.py``) gives every
number, as ``bench/calibrate.py`` reads the other cells'.

  python3 bench/calibrate_mla_moe.py --workload deepseek-v2-lite.serve-8k \
      --seeds 1,2,3 --control-seeds 1,2,3 --fault-seeds 4 --out build/cal.jsonl

For each seed it prints one JSON line: the program's numbers (one batch of
the mix, served with the routing record on, as many requests compared as a
run compares) and, for a control seed, the control's (the reference in
float8 with its own routing, in the program's place). ``flips`` gives how
many of the routing disagreements lie within each router-logit distance
of the reference's own k-th choice (near ties).

``--fault-seeds`` serves those seeds again with a routing fault planted in
the program (``FAULTS``: every token's top-k taken from its ranks 2 .. k+1,
in the decode steps of every MoE layer, or in both phases of one MoE layer)
and gives each fault's numbers: what the check has to see.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "bench"):
    del sys.path[0]
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from bench import harness, program, program_mla_moe as glue  # noqa: E402
from bench import traffic, weights_mla_moe  # noqa: E402
from bench.kinds import serve_moe  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

NEAR = (1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1)


@contextlib.contextmanager
def planted(n_moe: int, layers, phases):
    """A routing fault in the program while the block runs: in the MoE
    calls of ``layers`` (indices among the MoE layers; None: every one)
    and ``phases`` ("prefill", "decode"), every token's top-k are its
    ranks 2 .. k+1 (the first choice lost, the (k+1)-th taken). Calls are
    told apart by their order, which every forward and decode step keeps."""
    moe, ranked = mlp.moe, mlp._sorted
    calls = [0]

    def skip_first(probs):
        vals, idx = ranked(probs)
        return vals[..., 1:], idx[..., 1:]

    def faulty(*args, **kw):
        layer = calls[0] % n_moe
        calls[0] += 1
        phase = "decode" if kw.get("decode") else "prefill"
        if (layers is not None and layer not in layers) or phase not in phases:
            return moe(*args, **kw)
        mlp._sorted = skip_first
        try:
            return moe(*args, **kw)
        finally:
            mlp._sorted = ranked

    mlp.moe = faulty
    try:
        yield
    finally:
        mlp.moe = moe


def faults(n_moe: int) -> dict:
    """The faults the check must see: a decode-path routing fault at every
    layer, and one middle MoE layer's routing wrong in both phases."""
    return {"decode_every_layer": (None, ("decode",)),
            "one_layer": ((n_moe // 2,), ("prefill", "decode"))}


def _flips(deficits: torch.Tensor) -> dict:
    d = deficits.float().cpu()
    return {"n": int(d.numel()), "max": float(d.max()) if d.numel() else 0.0,
            **{f"under_{x:g}": int((d < x).sum()) for x in NEAR}}


def _numbers(args, control=False) -> dict:
    numbers, per_request = serve_moe.compare(*args, control=control)
    return dict(numbers, per_request={k: per_request[k].tolist() for k in (
                    "gap", "mean_gap", "route", "route_prefill",
                    "route_decode", "route_mean")},
                flips=_flips(per_request["flip_deficits"]))


def seed_row(c, seed: int, control: bool, dev, fault: str | None = None) -> dict:
    """One seed's readings: the program's (with ``fault``, one of
    ``faults``, planted) and, with ``control``, the control's."""
    cfg, mix = c.config, c.traffic
    pcfg = glue.program_config(cfg)
    params = glue.params(pcfg, weights_mla_moe.make(cfg, seed, dev), dev)
    b, p, g = mix["batch"], mix["prompt_len"], mix["gen_tokens"]
    record = glue.routing_record(pcfg, b, p + g, dev)
    prompts = traffic.prompts(mix, cfg["vocab_size"], seed, 0)
    n_moe = record.experts.shape[0]
    with (planted(n_moe, *faults(n_moe)[fault]) if fault
          else contextlib.nullcontext()):
        served, stats, ttft, routing = glue.serve(pcfg, params, prompts, g,
                                                  record)
    del params, record
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"ttft_s": ttft, "decode_s": stats["decode_s"],
           "capture_s": stats["decode_capture_s"]}
    args = (cfg, seed, [prompts], [served], [routing], mix["check_requests"], dev)
    t = time.perf_counter()
    out.update(_numbers(args))
    out["reference_s"] = time.perf_counter() - t
    if control:
        out["control"] = _numbers(args, control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    c = harness.cell(harness.load_spec(), args.workload)
    dev = torch.device("cuda")
    program.load_kernels(("flash_attention",))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    runs = [(int(s), None) for s in args.seeds.split(",") if s] \
        + [(int(s), fault) for s in args.fault_seeds.split(",") if s
           for fault in faults(c.config["num_hidden_layers"]
                               - c.config["first_k_dense_replace"])]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed, fault in runs:
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            row = seed_row(c, seed, fault is None and seed in controls, dev,
                           fault)
            row.update(workload=args.workload, seed=seed, fault=fault,
                       seconds=time.perf_counter() - t,
                       peak=int(torch.cuda.max_memory_allocated()))
            line = json.dumps(row, default=float)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
