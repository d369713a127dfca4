"""The port's launch specs and dry-run against the reference's.

``launch.specs``: the meta-tensor trees (inputs, params, train state,
decode caches) have the shapes and dtypes of the reference's
``jax.eval_shape`` trees, and the spec trees (train state, batch, caches,
tokens) are the reference's, for every config on the 16x16 and 2x16x16
meshes. ``launch.dryrun``: the four cells of tests/test_dryrun.py (which
fails on jax 0.9) run or skip as documented there, every field a shape-only
run cannot see is null with its reason, and the per-device bytes are the
structs' bytes over the specs' shares.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

torch.set_num_threads(1)

from repro.configs import ARCHS, SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jsp
from repro.parallel import sharding as jsh
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch._tree import leaves, map_with_path
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.parallel import sharding as tsh
from repro_torch.training.optimizer import AdamWConfig as TAdamWConfig

MESHES = {"16x16": (AbstractMesh((16, 16), ("data", "model")),
                    make_production_mesh()),
          "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                      make_production_mesh(multi_pod=True))}
KNOBS = {"q_chunk": 256, "ssm_chunk": 256, "mlstm_chunk": 256}


def _jflat(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(p.key if hasattr(p, "key") else p.idx for p in path): leaf
            for path, leaf in flat}


def _tflat(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _tflat_specs(tree) -> dict:
    out = {}

    def walk(x, path=()):
        if isinstance(x, tsh.P):
            out[path] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(x):
                walk(v, path + (i,))
    walk(tree)
    return out


def _same_structs(port, ref):
    """Equal paths, shapes and dtypes; every port leaf on the meta device."""
    jf, tf = _jflat(ref), _tflat(port)
    assert sorted(tf, key=str) == sorted(jf, key=str)
    for path, j in jf.items():
        t = tf[path]
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(j.shape), (path, t.shape, j.shape)
        assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name, \
            (path, t.dtype, j.dtype)


def _same_specs(port, ref):
    jf = _jflat(ref, is_leaf=lambda x: isinstance(x, JP))
    tf = _tflat_specs(port)
    assert sorted(tf, key=str) == sorted(jf, key=str)
    for path, spec in jf.items():
        assert tuple(tf[path]) == tuple(spec), (path, tf[path], spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_equal_the_reference(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    _same_structs(tsp.param_struct(tcfg), jsp.param_struct(jcfg))
    for shape in ("train_4k", "prefill_32k"):
        ref = jsp.input_specs(jcfg, SHAPES[shape])
        port = tsp.input_specs(tcfg, SHAPES[shape])
        _same_structs(port, ref)
    # caches at a small batch and length (their layout is what is compared)
    _same_structs(tsp.decode_cache_struct(tcfg, 2, 64),
                  jsp.decode_cache_struct(jcfg, 2, 64))


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "whisper-small"])
def test_train_state_struct_equals_the_reference(arch):
    jstate = jsp.train_state_struct(jget_config(arch),
                                    JAdamWConfig(moment_dtype="bfloat16"))
    tstate = tsp.train_state_struct(tget_config(arch),
                                    TAdamWConfig(moment_dtype="bfloat16"))
    _same_structs(tstate.params, jstate.params)
    _same_structs(tstate.opt.mu, jstate.opt.mu)
    _same_structs(tstate.opt.nu, jstate.opt.nu)
    _same_structs(tstate.opt.step, jstate.opt.step)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, mesh):
    jmesh, tmesh = MESHES[mesh]
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jr = jsh.ShardingRules(mesh=jmesh)
    tr = tsh.ShardingRules(mesh=tmesh)
    jstate = jsp.train_state_struct(jcfg, JAdamWConfig())
    tstate = tsp.train_state_struct(tcfg, TAdamWConfig())
    jspecs = jsp.train_state_specs(jr, jstate)
    tspecs = tsp.train_state_specs(tr, tstate)
    _same_specs(tspecs.params, jspecs.params)
    _same_specs(tspecs.opt.mu, jspecs.opt.mu)
    _same_specs(tspecs.opt.nu, jspecs.opt.nu)
    assert tuple(tspecs.opt.step) == tuple(jspecs.opt.step)
    for shape in SHAPES.values():
        _same_specs(tsp.batch_partition_specs(tr, tsp.input_specs(tcfg, shape)),
                    jsp.batch_partition_specs(jr, jsp.input_specs(jcfg, shape)))
        b = shape.global_batch
        for act in (None, jsh.SEQ_PARALLEL_ACT_RULES):
            jra = jsh.ShardingRules(mesh=jmesh, act_rules=act)
            tra = tsh.ShardingRules(mesh=tmesh, act_rules=act)
            _same_specs(tsp.decode_cache_specs(tra, tcfg, b, shape.seq_len),
                        jsp.decode_cache_specs(jra, jcfg, b, shape.seq_len))
            assert tuple(tsp.token_specs(tra, b)) \
                == tuple(jsp.token_specs(jra, b))


def test_dryrun_cells():
    """tests/test_dryrun.py's cells: one train cell on the single-pod mesh,
    one decode cell on the multi-pod mesh, one audio prefill, and long_500k
    on a pure full-attention arch, a documented skip."""
    out = {}
    for arch, shape, mp in [("xlstm-125m", "train_4k", False),
                            ("gemma3-1b", "decode_32k", True),
                            ("whisper-small", "prefill_32k", False),
                            ("qwen3-32b", "long_500k", False)]:
        out[(arch, shape)] = tdry.run_cell(arch, shape, mp, KNOBS,
                                           verbose=False)
    assert out[("xlstm-125m", "train_4k")]["ok"]
    assert out[("gemma3-1b", "decode_32k")]["ok"]
    assert out[("gemma3-1b", "decode_32k")]["mesh"] == "2x16x16"
    assert out[("whisper-small", "prefill_32k")]["ok"]
    assert "skipped" in out[("qwen3-32b", "long_500k")]
    for key, r in out.items():
        if not r.get("ok"):
            continue
        # every null field names its reason, and no unseen field reads 0
        for name, value in r["memory"].items():
            assert (value is None) == (f"memory.{name}" in r["unseen"]), name
        assert r["collectives"] is None and "collectives" in r["unseen"]
        assert r["roofline"]["seconds"]["collective"] is None
        assert r["roofline"]["bottleneck"] in ("compute", "memory")
        assert r["cost"]["flops"] > 0 and r["cost"]["bytes"] > 0
        assert r["hw"]["peak_flops"] == 989e12
        json.dumps(r)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def test_per_device_bytes_are_the_structs_over_the_specs():
    """On a 1 x 1 mesh a device holds every argument whole; on 16 x 16 each
    leaf's share; the donated caches alias the outputs' caches."""
    shape = ShapeSpec("decode_small", 64, 32, "decode")
    one = MeshShape((1, 1), ("data", "model"))
    r1 = tdry.run_cell("gemma3-1b", shape, False, KNOBS, verbose=False,
                       mesh=one)
    params = tsp.param_struct(tget_config("gemma3-1b"))
    caches = tsp.decode_cache_struct(tget_config("gemma3-1b"), 32, 64)
    token, pos = 32 * 4, 4
    assert r1["memory"]["argument_size_in_bytes"] \
        == _tree_bytes(params) + token + pos + _tree_bytes(caches)
    assert r1["memory"]["output_size_in_bytes"] == token + _tree_bytes(caches)
    assert r1["memory"]["alias_size_in_bytes"] == _tree_bytes(caches)
    assert r1["mesh"] == "1x1"
    r16 = tdry.run_cell("gemma3-1b", shape, False, KNOBS, verbose=False)
    assert r16["memory"]["argument_size_in_bytes"] \
        < r1["memory"]["argument_size_in_bytes"] / 16
    # the same program, priced at global shapes, divided over the mesh
    assert r16["cost"]["global_flops"] == r1["cost"]["global_flops"]
    assert r16["cost"]["flops"] * 256 == r1["cost"]["flops"]


def test_programs_are_priced_once_across_meshes_and_knobs_restored():
    from repro_torch.models import common as cc
    before = dict(cc.RUNTIME)
    programs = {}
    a = tdry.run_cell("starcoder2-3b", "decode_32k", False, KNOBS,
                      verbose=False, programs=programs)
    b = tdry.run_cell("starcoder2-3b", "decode_32k", True, KNOBS,
                      verbose=False, programs=programs)
    assert len(programs) == 1 and cc.RUNTIME == before
    assert a["cost"]["global_bytes"] == b["cost"]["global_bytes"]
    assert a["memory"] != b["memory"]


def test_main_writes_one_json_per_cell(tmp_path, capsys):
    rc = tdry.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                    "--both-meshes", "--out", str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["phi3-mini-3.8b__decode_32k__16x16.json",
                     "phi3-mini-3.8b__decode_32k__2x16x16.json"]
    assert "DRYRUN SUMMARY: 2 ok, 0 skipped, 0 failed" in capsys.readouterr().out


def _direct_cost(cfg, shape):
    from repro_torch.analysis import program_cost
    fn, args = tdry._step(cfg, shape, TAdamWConfig())
    return program_cost.analyze(fn, *args)


def _assert_same_cost(got, want):
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12, abs=0)
    assert got["bytes"] == pytest.approx(want["bytes"], rel=1e-12, abs=0)
    assert set(got["bytes_by_kind"]) == set(want["bytes_by_kind"])
    for k, v in want["bytes_by_kind"].items():
        assert got["bytes_by_kind"][k] == pytest.approx(v, rel=1e-9, abs=1e-3)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-small"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_depth_extrapolation_is_exact(arch, kind, monkeypatch):
    """A long segment is priced at 2 and 3 repeats and extrapolated (the
    reference prices a scanned body once x its trip count): the same cost
    as pricing every repeat."""
    from repro_torch.models import common as cc
    monkeypatch.setitem(cc.RUNTIME, "q_chunk", 8)
    cfg = treduce(tget_config(arch))
    cfg = dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, count=7) for s in cfg.segments),
        encoder_segments=tuple(dataclasses.replace(s, count=5)
                               for s in cfg.encoder_segments))
    shape = ShapeSpec("small", 32, 2, kind)
    prog = tdry._program(cfg, shape, None)
    assert len(prog["priced_as"]) == 1 + len(cfg.segments) \
        + len(cfg.encoder_segments)
    _assert_same_cost(prog["cost"], _direct_cost(cfg, shape))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_sequence_extrapolation_is_exact_for_the_recurrent_stack(kind,
                                                                 monkeypatch):
    """xlstm's mLSTM / sLSTM stack is linear in the sequence length above two
    mLSTM chunks: priced at 2 and 3 chunks and extrapolated, the same cost
    as pricing the whole sequence."""
    from repro_torch.models import common as cc
    monkeypatch.setitem(cc.RUNTIME, "mlstm_chunk", 16)
    cfg = treduce(tget_config("xlstm-125m"))
    shape = ShapeSpec("small", 128, 2, kind)
    prog = tdry._program(cfg, shape, None)
    assert [p["seq_len"] for p in prog["priced_as"]] == [32, 48]
    _assert_same_cost(prog["cost"], _direct_cost(cfg, shape))
