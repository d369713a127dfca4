"""The port's sharding rules against the reference's: every config's param
spec tree on the 16x16 and 2x16x16 meshes, the checks of
tests/test_sharding.py on the port, the activation resolver, and a DTensor
round trip of a reduced model's params on a 2x2 gloo mesh (4 ranks in
subprocesses).

The reference's own tests build ``AbstractMesh((("data", 16), ...))``,
which jax 0.9 refuses; its functions take ``AbstractMesh(sizes, names)``,
which is what the reference side uses here."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

torch.set_num_threads(1)

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.launch import specs as jsp
from repro.parallel import sharding as jsh
from repro_torch._tree import map_with_path
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as tsh

JMESH = AbstractMesh((16, 16), ("data", "model"))
JMESH3 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": (JMESH, make_production_mesh()),
          "2x16x16": (JMESH3, make_production_mesh(multi_pod=True))}
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _jax_flat(tree) -> dict:
    """path -> leaf of a reference tree, the path in the port's form (dict
    keys, list/tuple indices and NamedTuple fields by position)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, leaf in flat:
        key = tuple(p.key if hasattr(p, "key") else p.idx if hasattr(p, "idx")
                    else p.name for p in path)
        out[key] = leaf
    return out


def _torch_flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _specs_equal(port_tree, ref_tree, port_is_spec=True):
    """Equal leaves at equal paths; a port spec is a PartitionSpec leaf."""
    ref = _jax_flat(ref_tree)
    port = _torch_flat_specs(port_tree) if port_is_spec \
        else _torch_flat(port_tree)
    assert sorted(port, key=str) == sorted(ref, key=str)
    for path, spec in ref.items():
        assert tuple(port[path]) == tuple(spec), (path, port[path], spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = MESHES[mesh]
    for kw in ({}, {"fsdp": False}):
        ref = jsh.param_specs(jsh.ShardingRules(mesh=jmesh, **kw),
                              jsp.param_struct(jget_config(arch)))
        port = tsh.param_specs(tsh.ShardingRules(mesh=tmesh, **kw),
                               tsp.param_struct(tget_config(arch)))
        _specs_equal(port, ref)


def _check_divisibility(tree, specs, mesh):
    sizes = tsh.mesh_sizes(mesh)
    flat_s = _torch_flat_specs(specs)
    for path, leaf in _torch_flat(tree).items():
        for dim, ax in zip(leaf.shape, flat_s[path]):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            size = int(np.prod([sizes[a] for a in axes]))
            assert dim % size == 0, (path, leaf.shape)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b", "olmoe-1b-7b",
                                  "deepseek-v2-236b", "jamba-1.5-large-398b"])
def test_param_specs_divisible(arch):
    structs = tsp.param_struct(tget_config(arch))
    for mesh in (make_production_mesh(), make_production_mesh(multi_pod=True)):
        specs = tsh.param_specs(tsh.ShardingRules(mesh=mesh), structs)
        _check_divisibility(structs, specs, mesh)


def test_fit_axes_drops_nondivisible():
    mesh, mesh3 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert tsh._fit_axes(4, ("model",), mesh, set()) == ()
    assert tsh._fit_axes(64, ("model",), mesh, set()) == ("model",)
    assert tsh._fit_axes(32, ("pod", "data"), mesh3, set()) == ("pod", "data")
    assert tsh._fit_axes(2, ("pod", "data"), mesh3, set()) == ("pod",)
    assert tsh._fit_axes(1, ("pod", "data"), mesh3, set()) == ()
    for dim in (1, 2, 4, 6, 32, 48, 512, 6912):
        for axes in (("model",), ("pod", "data"), ("data", "model", "pod")):
            for used in (set(), {"data"}):
                assert tsh._fit_axes(dim, axes, mesh3, used) \
                    == jsh._fit_axes(dim, axes, JMESH3, used)


def test_moe_experts_on_model_axis_and_norms_replicated():
    olmoe = tsh.param_specs(tsh.ShardingRules(mesh=make_production_mesh()),
                            tsp.param_struct(tget_config("olmoe-1b-7b")))
    moe = olmoe["segments"][0][0]["moe"]
    assert moe["w_up"][1] == "model" and moe["w_down"][1] == "model"
    qwen = tsh.param_specs(tsh.ShardingRules(mesh=make_production_mesh()),
                           tsp.param_struct(tget_config("qwen3-32b")))
    norms = [(p, s) for p, s in _torch_flat_specs(qwen).items()
             if "norm" in "/".join(map(str, p))]
    assert norms and all(all(e is None for e in s) for _, s in norms)


def _torch_flat_specs(tree) -> dict:
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


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_resolver_and_batch_specs_equal_the_reference(mesh):
    jmesh, tmesh = MESHES[mesh]
    cases = [((256, 4096, 1152), ("act_batch", "act_seq", "act_embed")),
             ((8, 4096, 4, 256), ("act_batch", None, "act_heads", None)),
             ((1, 524288, 6912), ("act_batch", "act_kv_seq", "act_ff")),
             ((3, 5), ("act_batch", "act_vocab")),
             ((32, 1, 262144), ("act_batch", None, "act_vocab"))]
    for act in (None, jsh.SEQ_PARALLEL_ACT_RULES):
        jres = jsh.activation_resolver(jsh.ShardingRules(mesh=jmesh,
                                                         act_rules=act))
        tres = tsh.activation_resolver(tsh.ShardingRules(mesh=tmesh,
                                                         act_rules=act))
        for shape, axes in cases:
            ref = jres(shape, axes)
            port = tres(shape, axes)
            assert (None if ref is None else tuple(ref.spec)) \
                == (None if port is None else tuple(port))
    skel = {"tokens": ((256, 4096), np.int32), "one": ((1, 8), np.int32),
            "frames": ((2, 1500, 768), np.float32)}
    ref = jsh.batch_specs(jsh.ShardingRules(mesh=jmesh), skel)
    port = tsh.batch_specs(tsh.ShardingRules(mesh=tmesh), skel)
    assert {k: tuple(v) for k, v in port.items()} \
        == {k: tuple(v.spec) for k, v in ref.items()}


def test_mesh_shapes_and_placements():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape \
        == {"pod": 2, "data": 16, "model": 16}

    class _Mesh:        # placements read only the mesh's axis names
        mesh_dim_names = ("pod", "data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), _Mesh()) \
        == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, None), _Mesh()) == (Replicate(),) * 3


_DTENSOR_RANK = r"""
import sys
sys.path.insert(0, sys.argv[3])
import torch
torch.set_num_threads(1)
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import mesh as lm
from repro_torch.models import common as cc
from repro_torch.models import decoder_lm as dlm
from repro_torch.parallel import sharding as sh
rank, port = int(sys.argv[1]), int(sys.argv[2])
lm.init_process_group("gloo", world_size=4, rank=rank, port=port)
mesh = lm.device_mesh((2, 2), ("data", "model"), device="cpu")
cfg = reduce_for_smoke(get_config("olmoe-1b-7b"))
params = dlm.init_params(cfg, seed=0, device="cpu")     # the same on each rank
rules = sh.ShardingRules(mesh=mesh)
dist_params = sh.distribute_params(rules, params)
specs = sh.param_specs(rules, params)
n_sharded = 0
for t, d, spec in zip(leaves(params), leaves(dist_params),
                      [s for s in _flat(specs)]):
    assert tuple(d.placements) == sh.placements(spec, mesh), (spec, d.placements)
    assert torch.equal(d.full_tensor(), t)
    local = d.to_local()
    share = [mesh.size(i) for i, p in enumerate(d.placements) if p.is_shard()]
    assert local.numel() * (share[0] * share[1] if len(share) == 2 else
                            share[0] if share else 1) == t.numel()
    n_sharded += bool(share)
assert n_sharded > 0
# logical_constraint: a no-op on plain tensors, a redistribution on DTensors
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
x = torch.arange(4 * 8 * 32, dtype=torch.float32).reshape(4, 8, 32)
dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
cc.push_logical_rules(sh.activation_resolver(rules))
try:
    assert cc.logical_constraint(x, cc.BATCH, cc.SEQ, cc.EMBED) is x
    y = cc.logical_constraint(dx, cc.BATCH, cc.SEQ, cc.EMBED)
finally:
    cc.pop_logical_rules()
assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
assert torch.equal(y.full_tensor(), x)
assert cc.logical_constraint(dx, cc.BATCH, cc.SEQ) is dx   # no rules pushed
print("DTENSOR_OK", rank, n_sharded, flush=True)
"""

_FLAT = r"""
def _flat(tree):
    if isinstance(tree, sh.P):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for v in items for s in _flat(v)]
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dtensor_round_trip_on_a_2x2_gloo_mesh():
    """A reduced olmoe's params distributed by ``param_shardings`` over a
    (data 2, model 2) mesh of 4 gloo ranks: every leaf's placements are its
    spec's, its local shard the spec's share, and ``full_tensor`` the
    original bit for bit; ``logical_constraint`` moves a DTensor to the
    resolved placements and leaves a plain tensor alone."""
    code = _DTENSOR_RANK.replace("from repro_torch.parallel import sharding as sh",
                                 "from repro_torch.parallel import sharding as sh"
                                 + _FLAT)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               SRC], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "DTENSOR_OK" in out, out + err
