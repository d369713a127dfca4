"""End-to-end training run: a decoder LM trained for a few hundred steps
with checkpoint/restart mid-run (kill + resume produces the same loss
curve the uninterrupted run would).

Default is the reduced config (200 steps); ``--full`` trains the full
xlstm-125m:

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --full
"""
import argparse
import dataclasses
import shutil

from repro_torch import _device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="full xlstm-125m config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_e2e_ckpt_torch",
                    help="checkpoint directory, emptied first")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduce_for_smoke(cfg)
        cfg = dataclasses.replace(cfg, remat=False)
    ckpt = args.ckpt_dir
    shutil.rmtree(ckpt, ignore_errors=True)

    # phase 1: train to 60% of the steps, checkpointing
    half = int(args.steps * 0.6)
    _, hist1 = train_loop(cfg, half, global_batch=8, seq_len=128,
                          ckpt_dir=ckpt, ckpt_every=25, lr=1e-3,
                          device=device)

    # phase 2: 'crash' -> fresh process state -> auto-resume to the end
    print("\n-- simulated restart: resuming from latest checkpoint --\n")
    _, hist2 = train_loop(cfg, args.steps, global_batch=8, seq_len=128,
                          ckpt_dir=ckpt, ckpt_every=25, lr=1e-3,
                          device=device)

    first, last = hist1[0]["loss"], hist2[-1]["loss"]
    print(f"\nloss {first:.4f} -> {last:.4f} across a restart "
          f"({'improved' if last < first else 'NOT improved'})")
    if not last < first:
        raise AssertionError("training must make progress end-to-end")


if __name__ == "__main__":
    main()
