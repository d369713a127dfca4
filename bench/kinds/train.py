"""Kind ``train``: training steps of the program's donating step, replayed
by ``TrainGraph`` and fed by ``device_batch``, as ``train_loop`` runs them
on the card (no checkpoints).

Set-up builds one trainer from the seed's weights and drives it through
the mix's ``check_steps`` first steps, on rows that all differ; those steps
go through the window's own call and feed. The program's readings: each
step's loss, the first gradient's norm per leaf and layer as AdamW
received it (from its first moment), and the change of the weights per
leaf and layer after the checked steps. The window then goes on with the
same trainer, step after step with one step in flight, until
``--seconds`` have passed. A traced run profiles two whole steps of the
window.

End-to-end: ``train_tokens_per_s``, every token of the steps completed in
the window over the window's time, from its start to the end of its last
step.

``correct``: once the window has closed and the trainer is freed, the
reference trains the same checked steps from the same weights, and
``compare.train_numbers`` gives the ``loss``, ``grad`` and ``change`` gaps;
the cell's limits file names those it holds. ``checked_steps`` and
``compare`` are that check, and ``bench/calibrate.py`` reads its limits
through them.
"""
from __future__ import annotations

import time

import torch

from bench import program, traffic, weights
from bench.reference import compare as ref_compare
from bench.reference import train as ref_train

TRACED_STEPS = 2


def checked_steps(cfg: dict, mix: dict, seed: int, dev, batch):
    """The trainer, built from the seed's weights and driven through the
    mix's ``check_steps`` first steps on ``batch(k)``, and the program's
    readings of them."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # a graph's capture cannot use the cache
    specs = {s[0]: s for s in weights.leaf_specs(cfg)}
    names = [(n, s[1][0] if n.startswith("layers.") else 0)
             for n, s in specs.items()]
    pcfg = program.program_config(cfg)
    trainer = program.Trainer(
        pcfg, mix["optimizer"],
        program.params(pcfg, weights.make(cfg, seed, dev), dev), dev)
    prog = {"loss": []}
    for k in range(mix["check_steps"]):
        metrics = trainer.step(*batch(k))
        prog["loss"].append(float(metrics["loss"]))
        if k == 0:
            prog["grad"] = trainer.first_grad_norms(names)
    prog["change"] = trainer.change_norms(
        names, lambda name, i: weights.draw(specs[name], seed, dev, i))
    return trainer, prog


def compare(cfg: dict, mix: dict, seed: int, prog: dict, dev,
            control: bool = False) -> dict:
    """The reference's training of the checked steps from the same
    weights, against the program's readings: {"program": numbers,
    "loss_ref": its losses}, and with ``control`` the numbers of the
    reference in float8 in the program's place."""
    batches = [tuple(torch.as_tensor(a, device=dev).long()
                     for a in traffic.train_batch(mix, cfg["vocab_size"], seed, i))
               for i in range(mix["check_steps"])]
    draw = lambda spec, i: weights.draw(spec, seed, dev, i)
    ref = ref_train.readings(cfg, mix["optimizer"], draw, batches)
    out = {"program": ref_compare.train_numbers(prog, ref), "loss_ref": ref["loss"]}
    if control:
        ctl = ref_train.readings(cfg, mix["optimizer"], draw, batches, "fp8")
        out["control"] = ref_compare.train_numbers(ctl, ref)
    return out


def run(r) -> None:
    cfg, mix, dev = r.config, r.traffic, r.device
    if dev.type == "cuda":
        program.load_kernels(("flash_attention",))
    batch = lambda k: traffic.train_batch(mix, cfg["vocab_size"], r.seed, k)
    trainer, prog = checked_steps(cfg, mix, r.seed, dev, batch)
    r.setup_done()

    cuda = dev.type == "cuda"
    k = mix["check_steps"]
    steps, prev = 0, None
    t0 = time.perf_counter()
    while True:
        if r.trace and steps == 1:
            with r.tracer() as tr:
                for _ in range(TRACED_STEPS):
                    trainer.step(*batch(k))
                    k, steps = k + 1, steps + 1
            r.traced = tr.result
            r.profiled = {"steps": TRACED_STEPS, "batch": mix["batch"],
                          "seq_len": mix["seq_len"]}
            prev = None
        else:
            trainer.step(*batch(k))
            k, steps = k + 1, steps + 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
        if time.perf_counter() - t0 >= r.seconds and (not r.trace
                                                     or r.traced is not None):
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0

    r.attempted = steps
    r.e2e["train_tokens_per_s"] = steps * mix["batch"] * mix["seq_len"] / window
    r.read_peak_memory()
    trainer.close()
    del trainer
    if cuda:
        torch.cuda.empty_cache()

    numbers = compare(cfg, mix, r.seed, prog, dev)["program"]
    r.checks = {k: numbers[k] for k in ("loss", "grad", "change")}
    r.failed = sum(r.checks[k] > limit for k, limit in r.cell.limits.items())
