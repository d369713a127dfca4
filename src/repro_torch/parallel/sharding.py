"""Divisibility-aware sharding rules: logical axes -> mesh axes. Port of
``repro/parallel/sharding.py``.

Parallelism layout:
  * ``data``  axis — batch DP + FSDP (weights/optimizer ZeRO-3-sharded).
  * ``model`` axis — tensor parallel: attention heads / d_ff / experts /
              vocab.
  * ``pod``   axis — pure DP (batch); parameters replicated across pods so
              the only cross-pod traffic is the gradient all-reduce (the
              Hulk placement insight applied to the production mesh).

Every rule is **divisibility-aware**: an axis only applies when the tensor
dim is divisible by the mesh axis size; otherwise the axis is dropped (e.g.
gemma3's 4 heads cannot take model=16 TP — the TP lands on d_ff=6912
instead). This is what lets one rule set serve all 10 architectures.

Parameter classification is by leaf *path name* (the param trees are plain
nested dicts, so path names are stable API):
  column-parallel (output dim on ``model``): wq wk wv w_up w_gate wq_b wkv_b
      up in_proj ffn_gate ffn_up x_proj dt_proj w_gates
  row-parallel (input dim on ``model``):     wo w_down down out_proj ffn_down
  expert-parallel (dim0 on ``model``):       moe/w_up moe/w_gate moe/w_down
  vocab-parallel (dim0 on ``model``):        embed  (lm_head: last dim)
  replicated: norms, biases, gates, routers, scalar/1-d leaves.
The remaining largest dim is FSDP-sharded on ``data``. Stacked segments get
a leading None for the count axis.

The specs are ``PartitionSpec``s, a tuple per tensor with one entry per
dim (None, an axis name, or a tuple of axis names), as JAX's. The mesh is
either shape-only (``launch.mesh.MeshShape``: axis names and sizes, no
devices, for the production meshes) or a real
``torch.distributed.device_mesh.DeviceMesh``; ``placements`` turns a spec
into DTensor ``Shard`` / ``Replicate`` placements on the latter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch._tree import map_with_path, tree_map

PyTree = Any


class PartitionSpec(tuple):
    """A tensor's sharding: one entry per dim, None (replicated), a mesh
    axis name, or a tuple of axis names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Activation logical-axis rules: logical name -> mesh axes (tried in order,
# dropped when not divisible).
#
# act_seq -> model is Megatron-style SEQUENCE PARALLELISM on the residual
# stream: between layers activations live seq-sharded over the TP axis, and
# the all-gather comes before each TP projection and the reduce-scatter
# after wo / w_down. Tensor-internal constraints (heads, ff, vocab)
# deliberately pass None for the seq dim so the TP dim wins there.
DEFAULT_ACT_RULES: dict[str, tuple[str, ...]] = {
    "act_batch": ("pod", "data"),
    "act_seq": ("model",),
    "act_kv_seq": (),
    "act_heads": ("model",),
    "act_ff": ("model",),
    "act_expert": ("model",),
    "act_embed": (),
    "act_vocab": ("model",),
}

# Sequence-parallel variant for decode shapes whose batch cannot shard
# (long_500k: B=1): the KV-cache / sequence dim rides the data axis.
SEQ_PARALLEL_ACT_RULES = dict(
    DEFAULT_ACT_RULES,
    act_seq=(),
    act_kv_seq=("data",),
)

_COLUMN = ("wq", "wk", "wv", "w_up", "w_gate", "wq_b", "wkv_b", "up",
           "in_proj", "ffn_gate", "ffn_up", "w_gates", "wq_a", "wkv_a",
           "x_proj", "ogate_skip", "w1")
_ROW = ("wo", "w_down", "down", "out_proj", "ffn_down", "dt_proj", "w2")
_REPLICATED = ("norm", "scale", "bias", "b_i", "b_f", "b_gates", "dt_bias",
               "a_log", "d_skip", "conv_w", "conv_b", "r_gates", "router",
               "slot_pos")


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a shape-only mesh or a ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                                  # MeshShape or DeviceMesh
    data_axes: tuple[str, ...] = ("data",)     # FSDP axes for params
    model_axes: tuple[str, ...] = ("model",)   # TP axes
    act_rules: Optional[dict] = None           # None -> DEFAULT_ACT_RULES
    fsdp: bool = True                          # ZeRO-3 weight sharding

    def axis_size(self, axes: Sequence[str]) -> int:
        sizes = mesh_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in axes], dtype=np.int64)) \
            if axes else 1


def _fit_axes(dim: int, axes: Sequence[str], mesh,
              used: set) -> tuple[str, ...]:
    """Longest prefix of `axes` whose product divides `dim` (skipping axes
    already used by another dim of this tensor and axes absent from mesh)."""
    sizes = mesh_sizes(mesh)
    out = []
    prod = 1
    for a in axes:
        if a in used or a not in sizes:
            continue
        if dim % (prod * sizes[a]) == 0:
            out.append(a)
            prod *= sizes[a]
    return tuple(out)


def _path_names(path) -> list[str]:
    """Dict keys as they are, list indices as "[i]" (the reference's
    ``DictKey`` / ``SequenceKey`` names)."""
    return [f"[{p}]" if isinstance(p, int) else str(p) for p in path]


def _classify(names: list[str]) -> str:
    leaf = names[-1] if names else ""
    joined = "/".join(names)
    if any(t in joined for t in ("norm", "ln_")):
        return "replicated"
    if leaf in _REPLICATED or leaf.startswith("b_"):
        return "replicated"
    if "moe" in joined and leaf in ("w_up", "w_gate", "w_down"):
        return "expert"
    if leaf == "embed":
        return "vocab_rows"
    if leaf == "lm_head":
        return "vocab_cols"
    if leaf in _COLUMN:
        return "column"
    if leaf in _ROW:
        return "row"
    return "generic"


def _leaf_spec(rules: ShardingRules, names: list[str], shape: tuple,
               n_stack: int) -> P:
    """PartitionSpec for one param leaf. n_stack leading dims (stacked
    segment count axes) stay unsharded."""
    mesh = rules.mesh
    kind = _classify(names)
    core = shape[n_stack:]
    spec: list = [None] * len(shape)
    used: set = set()
    if kind == "replicated" or not core:
        return P(*spec)

    def assign(dim_idx: int, axes: Sequence[str]):
        fitted = _fit_axes(shape[dim_idx], axes, mesh, used)
        if fitted:
            spec[dim_idx] = fitted if len(fitted) > 1 else fitted[0]
            used.update(fitted)
            return True
        return False

    first, last = n_stack, len(shape) - 1
    if kind == "column":
        assign(last, rules.model_axes)
        if rules.fsdp and len(core) >= 2:
            assign(first, rules.data_axes)
    elif kind == "row":
        assign(first, rules.model_axes)
        if rules.fsdp and len(core) >= 2:
            assign(last, rules.data_axes)
    elif kind == "expert":
        assign(first, rules.model_axes)          # experts on model axis (EP)
        if rules.fsdp and len(core) >= 2:
            assign(last, rules.data_axes)
    elif kind == "vocab_rows":                    # embed (V, D)
        assign(first, rules.model_axes)
        if rules.fsdp:
            assign(last, rules.data_axes)
    elif kind == "vocab_cols":                    # lm_head (D, V)
        assign(last, rules.model_axes)
        if rules.fsdp:
            assign(first, rules.data_axes)
    else:  # generic: FSDP the largest core dim
        if rules.fsdp:
            big = max(range(n_stack, len(shape)), key=lambda i: shape[i])
            assign(big, rules.data_axes)
    return P(*spec)


def param_specs(rules: ShardingRules, params: PyTree,
                scan_stacked: bool = True) -> PyTree:
    """PartitionSpec tree matching `params` (a tree of tensors, meta ones
    included). Leaves under a 'segments' path with a leading count dim get a
    leading None when scan_stacked."""

    def one(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        n_stack = 0
        if scan_stacked and "segments" in names:
            # stacked leaves carry the count axis first; detected by rank
            # against the unstacked leaf's (norm scales are 1-d unstacked,
            # 2-d stacked)
            n_stack = 1 if _is_stacked(names, shape) else 0
        return _leaf_spec(rules, names, shape, n_stack)

    return map_with_path(one, params)


def _is_stacked(names: list[str], shape: tuple) -> bool:
    leaf = names[-1]
    base_rank = {"scale": 1, "bias": 1, "b_i": 1, "b_f": 1, "b_gates": 1,
                 "dt_bias": 1, "conv_b": 1, "d_skip": 1, "w_edge": 1,
                 "a_log": 2, "conv_w": 2, "r_gates": 3}.get(leaf)
    if base_rank is None:
        # matmul weights: 2-d unstacked (3-d stacked); MoE experts 3-d (4-d)
        in_moe = "moe" in names
        base_rank = 3 if in_moe and leaf in ("w_up", "w_gate", "w_down") else 2
    return len(shape) > base_rank


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: mesh
    dim i is ``Shard(d)`` when tensor dim d's entry names mesh axis i, else
    ``Replicate()``. A dim sharded over several axes lists them major to
    minor, as DTensor splits over mesh dims in order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def compute_placements(spec: P, mesh) -> tuple:
    """``placements(spec, mesh)`` for tensors that are computed on, with
    ``Replicate()`` on every mesh dim of size 1: a split over one rank is
    the same layout as none, and DTensor's view rules refuse to split or
    merge a dim sharded even over one rank (a reshape of a KV projection
    with one head, sharded over a ``model`` axis of size 1)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if n == 1 else p
                 for p, n in zip(placements(spec, mesh), mesh.mesh.shape))


def param_shardings(rules: ShardingRules, params: PyTree) -> PyTree:
    """DTensor placements of every param leaf on ``rules.mesh`` (a
    ``DeviceMesh``)."""
    # mapped over the params: a spec is a tuple, which tree_map would enter
    return tree_map(lambda _, s: placements(s, rules.mesh), params,
                    param_specs(rules, params))


def distribute_params(rules: ShardingRules, params: PyTree) -> PyTree:
    """Every leaf as a ``DTensor`` on ``rules.mesh`` placed by
    ``param_shardings``. Each rank passes the full tensors, on the mesh's
    device type (as ``distribute_tensor`` takes them)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, pl: distribute_tensor(t, rules.mesh, pl),
                    params, param_shardings(rules, params))


def distribute(mesh, tree: PyTree, specs: PyTree) -> PyTree:
    """Every leaf of ``tree`` as a ``DTensor`` on the ``DeviceMesh``
    ``mesh``, placed by its ``PartitionSpec`` in ``specs`` (a tree of the
    same structure) for computing on (``compute_placements``). Each rank
    passes the whole tensors, the same on every rank, and keeps its
    shards."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(
        lambda t, s: distribute_tensor(t, mesh, compute_placements(s, mesh)),
        tree, specs)


def replicate(mesh, batch: dict) -> dict:
    """A batch dict of tensors, whole on every rank, as replicated
    ``DTensor``s on ``mesh`` (the reference's ``in_shardings=None``): no
    data moves, each rank wraps its own copy."""
    from torch.distributed.tensor import DTensor, Replicate
    whole = (Replicate(),) * mesh.ndim
    return {k: DTensor.from_local(v, mesh, whole, run_check=False)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activation_resolver(rules: ShardingRules):
    """Resolver for models.common.logical_constraint: (shape, logical axes)
    -> PartitionSpec (or None to skip)."""
    act_rules = rules.act_rules or DEFAULT_ACT_RULES
    mesh = rules.mesh

    def resolve(shape, axes):
        spec: list = [None] * len(shape)
        used: set = set()
        for i, name in enumerate(axes):
            if name is None or i >= len(shape):
                continue
            cand = act_rules.get(name, ())
            fitted = _fit_axes(shape[i], cand, mesh, used)
            if fitted:
                spec[i] = fitted if len(fitted) > 1 else fitted[0]
                used.update(fitted)
        if all(s is None for s in spec):
            return None
        return P(*spec)

    return resolve


def batch_specs(rules: ShardingRules, batch_skeleton: dict) -> dict:
    """Input specs for a batch dict of (shape, dtype): dim0 = batch over
    (pod, data) when divisible, else replicated; other dims unsharded."""
    mesh = rules.mesh
    out = {}
    for k, (shape, _dtype) in batch_skeleton.items():
        fitted = _fit_axes(shape[0], ("pod",) + tuple(rules.data_axes), mesh,
                           set())
        spec = [None] * len(shape)
        if fitted:
            spec[0] = fitted if len(fitted) > 1 else fitted[0]
        out[k] = P(*spec)
    return out
