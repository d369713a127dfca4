"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` per run.

  python3 bench/run.py --workload phi3-mini-3.8b.decode-4k --seed 7 \
      --seconds 50 --trace 0

Runs on the CUDA card of the machine it is started on, from the root of a
checkout; exits 2 without a result where there is none. Prints the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics from one
profiled stretch of the window (``--trace 1``) as one JSON line, last on
standard output, and each number compared with its limit as the last lines
on standard error. The program's kernels build into ``build/kernels``
inside the checkout on a cell's first run there.
"""
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "bench"):
    del sys.path[0]           # bench/'s modules are imported as bench.*
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import argparse  # noqa: E402
import json  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from bench import harness

    spec = harness.load_spec()
    cell = harness.cell(spec, args.workload)
    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}", file=sys.stderr)
        return 3
    out = harness.result(run)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
