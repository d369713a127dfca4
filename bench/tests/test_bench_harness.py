"""The harness on the CPU: arguments, finding configurations, mixes, limits,
kinds and metric readers by name, the spec's own rules, and the result
line's keys from whole runs of small cells (no look for a card)."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness, run
from bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"((hidden|intermediate|latent|state|proj|head).*size|_dim$|"
                   r"_rank$|expan|experts_per_tok|window)")
torch.set_num_threads(2)


def test_arguments():
    a = run.parse(["--workload", "phi3-mini-3.8b.decode-4k", "--seed",
                   str(2 ** 31 + 99), "--seconds", "40", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "phi3-mini-3.8b.decode-4k", 2 ** 31 + 99, 40.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                   "--trace", "2"])


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        c = harness.cell(SPEC, w["name"])
        assert c.config["name"] == w["config"]
        assert (BENCH / "kinds" / f"{c.traffic['kind']}.py").exists()
        assert set(c.limits)
        for m in c.per_layer:
            assert hasattr(harness.reader(m["name"]), "read")
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
        assert all(m["moves"] in reported for m in c.per_layer)
    with pytest.raises(KeyError):
        harness.cell(SPEC, "no-such-cell")


def test_the_spec_keeps_its_rules():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    for n in names + cells + [c["name"] for c in SPEC["configs"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert c["file"].startswith("bench/")
    assert set(SPEC["paths"]) == {"bench"}
    # a full check of 24 cells at this run length fits its time
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    c = tiny.cell(workload)
    r = harness.execute(c, 2 ** 31 + 17, 0.2, bool(trace), "cpu")
    out = harness.result(r)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(out["checks"]) == set(c.limits)
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert out["attempted"] > 0 and out["failed"] >= 0
    assert isinstance(out["correct"], bool)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in out
        # no device ran: no device metric is read from a CPU trace
        assert not any(m in out["metrics"] for m in (
            "mfu.train", "mfu.decode", "device_idle.train", "device_idle.decode"))
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_the_same_seed_gives_the_same_inputs():
    c = tiny.cell("phi3-mini-3.8b.decode-4k")
    a = [harness.execute(c, 2 ** 31 + 5, 0.0, False, "cpu").checks["gap"]
         for _ in range(2)]
    assert a[0] == a[1]


def test_without_a_card_it_exits_without_a_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
