"""The readings that the limits under ``bench/limits`` are set from, one
process for many seeds (not run by the benchmark's own runs).

  python3 bench/calibrate.py --workload phi3-mini-3.8b.decode-4k \
      --seeds 1,2,3 --control-seeds 1,2,3 --out build/cal.jsonl

For each seed it prints one JSON line with the numbers a run compares, at
the cell's own sizes, through the kind's own check (``compare`` of
``bench/kinds/<kind>.py``): the program's; for a control seed also the
control's (the reference computed with float8 projections, put in the
program's place); for a training cell with ``--faults`` also those of a run
whose timed path leaves half of each batch out of the loss. A serving seed
serves one batch, the mix's, and compares as many requests as a run does;
a training seed makes the checked steps only.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "bench"):
    del sys.path[0]
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from bench import harness, program, traffic, weights  # noqa: E402
from bench.kinds import serve_batch, train  # noqa: E402


def serve_seed(c, seed: int, control: bool, dev) -> dict:
    cfg, mix = c.config, c.traffic
    pcfg = program.program_config(cfg)
    params = program.params(pcfg, weights.make(cfg, seed, dev), dev)
    prompts = traffic.prompts(mix, cfg["vocab_size"], seed, 0)
    served, stats, ttft = program.serve(pcfg, params, prompts, mix["gen_tokens"])
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"ttft_s": ttft, "decode_s": stats["decode_s"]}
    args = (cfg, seed, [prompts], [served], mix["check_requests"], dev)
    numbers, per_request = serve_batch.compare(*args)
    out.update(numbers, per_request={k: v.tolist() for k, v in per_request.items()})
    if control:
        out["control"], _ = serve_batch.compare(*args, control=True)
    return out


def _half_labels(batch):
    """The fault: the second half of each batch's rows left out of the loss."""
    def half(k):
        tokens, labels = batch(k)
        labels = labels.copy()
        labels[labels.shape[0] // 2:] = -100
        return tokens, labels
    return half


def _program_readings(cfg, mix, seed, dev, batch) -> dict:
    trainer, prog = train.checked_steps(cfg, mix, seed, dev, batch)
    trainer.close()
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def train_seed(c, seed: int, control: bool, faults: bool, dev) -> dict:
    cfg, mix = c.config, c.traffic
    batch = lambda k: traffic.train_batch(mix, cfg["vocab_size"], seed, k)
    t0 = time.perf_counter()
    prog = _program_readings(cfg, mix, seed, dev, batch)
    t1 = time.perf_counter()
    out = train.compare(cfg, mix, seed, prog, dev, control)
    out.update(program_s=t1 - t0, reference_s=time.perf_counter() - t1,
               loss_prog=prog["loss"])
    if faults:
        half = _program_readings(cfg, mix, seed, dev, _half_labels(batch))
        out["half_batch"] = train.compare(cfg, mix, seed, half, dev)["program"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    c = harness.cell(harness.load_spec(), args.workload)
    dev = torch.device("cuda")
    program.load_kernels(("flash_attention",) if c.traffic["kind"] == "train"
                         else ("flash_attention", "decode_attention"))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            if c.traffic["kind"] == "train":
                row = train_seed(c, seed, seed in controls, args.faults, dev)
            else:
                row = serve_seed(c, seed, seed in controls, dev)
            row.update(workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t,
                       peak=int(torch.cuda.max_memory_allocated()))
            line = json.dumps(row, default=float)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
