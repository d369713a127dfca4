"""The harness on the card at small sizes: every cell's kind through the
program's kernels and graphs, traced and not, ``correct`` true and every
device metric read from the trace. Float32 models, which the program
matches to rounding at any size (a small bfloat16 model reads further
from the reference than the full-size one the limits were set on). Needs
a CUDA card; skips without one."""
import pytest
import torch

from bench import harness
from bench.tests import tiny
from bench.tests.test_bench_harness import SPEC

DEVICE_METRICS = {"mfu.train", "mfu.decode", "device_idle.train",
                  "device_idle.decode", "flash_fwd_roofline.serve",
                  "flash_bwd_roofline", "decode_attention_roofline"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    c = tiny.cell(workload, dtype="float32")
    r = harness.execute(c, 2 ** 31 + 23, 1.0, bool(trace), card)
    out = harness.result(r)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        want = {m["name"] for m in c.per_layer}
        assert want & DEVICE_METRICS <= set(out["metrics"]), out["metrics"]
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for name in ("mfu.train", "mfu.decode"):
            if name in out["metrics"]:
                assert 0 < out["metrics"][name]["value"] <= 100
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
