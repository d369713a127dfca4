"""The control comes out not correct against each cell's own limits, at a
size a test run holds on the CPU: the reference computed with float8
projections (e4m3 operands, e5m2 gradients, a scale per tensor), the step
below the configurations' bfloat16, put in the program's place. Its
readings go through the kind's own check (``bench/calibrate.py`` calls it)
into a ``Run``, which ``harness.correct`` judges as it judges a run. The
program, at the same size, passes the same limits where its readings at
that size are comparable (serving). The readings at the cells' own sizes,
on the card, are in PERF.md."""
import pytest
import torch

from bench import calibrate, harness
from bench.tests import tiny

SEEDS = [11, 12, 13]
CPU = torch.device("cpu")
torch.set_num_threads(2)


def judged(c, checks: dict) -> bool:
    """``correct`` of a run of cell ``c`` whose check read ``checks``."""
    r = harness.Run(cell=c, seed=0, seconds=0.0, trace=False, device=CPU,
                    t_process=0.0)
    r.checks = {k: checks[k] for k in c.limits}
    return harness.correct(r)


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_control_is_not_correct(seed):
    # phi3-mini's hidden width, so the logits have its spread; few layers
    c = tiny.cell("phi3-mini-3.8b.decode-4k", hidden=3072, batch=4,
                  prompt_len=32, gen_tokens=32, check_requests=4)
    c.config["vocab_size"] = 8192
    out = calibrate.serve_seed(c, seed, True, CPU)
    assert not judged(c, out["control"])
    assert judged(c, out)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_is_not_correct(seed):
    c = tiny.cell("phi3-mini-3.8b.16-layers.train-4k")
    out = calibrate.train_seed(c, seed, True, False, CPU)
    ctl, prog = out["control"], out["program"]
    assert not judged(c, ctl)
    # and it reads well apart from the program at the same size
    assert ctl["grad"] >= 3 * prog["grad"]


def test_the_cells_name_what_these_tests_cover():
    names = {w["name"] for w in harness.load_spec()["workloads"]}
    assert names == {"phi3-mini-3.8b.decode-4k",
                     "phi3-mini-3.8b.16-layers.train-4k"}
