"""Cells at a size the CPU runs in seconds, for the harness's tests: the
benchmark's own configurations and mixes with every size cut down (the
shapes kept: grouped heads, and a sliding window shorter than the
sequences, so that prefill and decode run the window's ring cache)."""
from __future__ import annotations

from bench import harness
from bench.harness import _json


WINDOW = 8


def config(name: str, dtype: str = "bfloat16", hidden: int = 64) -> dict:
    c = _json("configs", name)
    c.update(hidden_size=hidden, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=256, torch_dtype=dtype)
    if c["sliding_window"] is not None:
        c["sliding_window"] = WINDOW
    return c


def traffic(name: str) -> dict:
    t = _json("traffic", name)
    if t["kind"] == "train":
        t.update(batch=2, seq_len=16)
    else:
        t.update(batch=2, prompt_len=16, gen_tokens=6, check_requests=2)
    return t


def cell(workload: str, limits: dict | None = None, dtype: str = "bfloat16",
         hidden: int = 64, **mix):
    """The tiny version of a workload of BENCHMARK.json (``mix`` overrides
    sizes of its traffic)."""
    spec = harness.load_spec()
    w = next(x for x in spec["workloads"] if x["name"] == workload)
    full = harness.cell(spec, workload)
    return harness.Cell(name=workload, config=config(w["config"], dtype, hidden),
                        traffic=dict(traffic(w["traffic"]), **mix),
                        limits=full.limits if limits is None else limits,
                        end_to_end=full.end_to_end, per_layer=full.per_layer)
