"""Dry-run of every (arch x shape x mesh) cell, shape only. Port of
``repro/launch/dryrun.py``.

For each cell this:
  1. builds the mesh: the production shapes (16x16 single-pod / 2x16x16
     multi-pod, ``launch.mesh.MeshShape``, no devices) unless the caller
     gives one,
  2. makes meta-tensor stand-ins for the step's inputs (``launch.specs``:
     the real initializers on the meta device, nothing allocated) and their
     partition specs,
  3. runs the step itself on those stand-ins under ``analysis.program_cost``
     at global shapes (flops from aten's formulas, bytes per op),
  4. takes the per-device argument, output and donated (aliased) bytes from
     the structs and specs exactly — the counterpart of XLA's
     ``memory_analysis()`` argument and output sizes — and divides the
     flops and bytes evenly over the mesh,
  5. writes the roofline (``analysis.roofline`` with the card's ``HW``).

What a shape-only torch run cannot see is reported as ``null`` with a reason
under ``unseen``, never as 0: XLA's temp / peak / generated-code sizes (the
activations of a step live only while it runs) and the collectives, which
the reference reads from the partitioned HLO.

The reference's first lines force 512 host devices; the port needs no
devices for a shape-only mesh and sets nothing global.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes --out d/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.analysis import program_cost
from repro_torch.analysis.roofline import (HW, active_params, model_flops,
                                           roofline_report)
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as cc
from repro_torch.models.registry import get_api
from repro_torch.parallel.sharding import (P, SEQ_PARALLEL_ACT_RULES,
                                           ShardingRules, mesh_sizes)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (make_decode_step, make_prefill,
                                             make_train_step)

# Params big enough that serving must FSDP the weights over `data` too
# (won't fit model-axis TP alone in 16 GB HBM).
_SERVE_FSDP_BYTES = 8e9 * 16   # 8 GB/device x model axis

UNSEEN = {
    "memory.temp_size_in_bytes": (
        "activations and workspaces live only while the step runs; a "
        "shape-only torch run has no compiler buffer assignment to read"),
    "memory.peak_memory_in_bytes": (
        "needs the temp size: arguments + outputs - aliases is its lower "
        "bound (fits_lower_bound)"),
    "memory.generated_code_size_in_bytes": "eager torch generates no code",
    "collectives": (
        "tensor-parallel activation collectives and FSDP gathers are placed "
        "by a partitioner at run time; the program priced here is one "
        "rank's, at global shapes, and moves none"),
}


def _knob_defaults(args) -> dict:
    return {
        "q_chunk": args.q_chunk,
        "ssm_chunk": args.ssm_chunk,
        "mlstm_chunk": args.mlstm_chunk,
    }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _per_device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of ``tree`` placed by ``spec_tree``: each leaf
    divided by the sizes of the mesh axes its spec names (the specs are
    divisibility-aware, so every division is exact). A spec that is one
    ``P`` places every leaf of ``tree`` alike."""
    sizes = mesh_sizes(mesh)

    def one(t, spec):
        axes = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        share = math.prod(sizes[a] for a in axes)
        assert _nbytes(t) % share == 0, (t.shape, spec)
        return _nbytes(t) // share

    if isinstance(spec_tree, P):
        return sum(one(t, spec_tree) for t in leaves(tree))
    return sum(leaves(tree_map(one, tree, spec_tree)))


def _total_params(struct_p) -> float:
    return sum(float(math.prod(t.shape)) for t in leaves(struct_p))


def run_cell(arch: str, shape_name, multi_pod: bool, knobs: dict,
             opt_overrides: dict | None = None, verbose: bool = True, *,
             mesh=None, hw: HW = HW(), programs: dict | None = None) -> dict:
    """One cell. ``shape_name`` names an entry of ``SHAPES`` or is a
    ``ShapeSpec``; ``mesh`` (a ``MeshShape`` or a ``DeviceMesh``) replaces
    the production mesh. ``knobs`` set ``models.common.RUNTIME`` for the
    priced step (``use_flash`` off unless a knob turns it on: the kernels'
    plain functions are what a meta run can price) and are restored after.
    The priced program does not depend on the mesh (it runs at global
    shapes); a caller that prices one cell on several meshes passes one
    ``programs`` dict to every call, which keeps each program priced once."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    sizes = mesh_sizes(mesh)
    result = {"arch": arch, "shape": shape.name,
              "mesh": "x".join(str(n) for n in sizes.values())}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result["skipped"] = why
        return result
    if shape.kind == "decode" and cfg.family == "audio" \
            and shape.name == "long_500k":
        result["skipped"] = "audio long_500k (full attention)"
        return result

    n_chips = math.prod(sizes.values())
    t0 = time.time()
    key = (arch, shape, tuple(sorted(knobs.items())),
           tuple(sorted((opt_overrides or {}).items())))
    programs = {} if programs is None else programs
    if key not in programs:
        saved = dict(cc.RUNTIME)
        cc.RUNTIME.update({"use_flash": False, **knobs})
        try:
            programs[key] = _program(cfg, shape, opt_overrides)
        finally:
            cc.RUNTIME.clear()
            cc.RUNTIME.update(saved)
    prog = programs[key]
    n_active = prog["active_params"]
    result["active_params"] = n_active
    mem = _memory(cfg, shape, prog, mesh)
    price_s = time.time() - t0

    if shape.kind == "train":
        mflops = model_flops(n_active, shape.global_batch * shape.seq_len,
                             "train")
    elif shape.kind == "prefill":
        mflops = model_flops(n_active, shape.global_batch * shape.seq_len,
                             "train") / 3.0   # fwd only
    else:
        mflops = model_flops(n_active, float(shape.global_batch), "decode")
    cost = prog["cost"]
    per_dev = {"flops": cost["flops"] / n_chips,
               "bytes": cost["bytes"] / n_chips}
    roof = roofline_report(per_dev, {"total": 0.0}, n_chips, mflops, hw)
    roof["seconds"]["collective"] = None
    roof["collective_raw_s"] = None
    roof["per_device"]["collective_bytes"] = None
    roof["per_device"]["collective_bytes_raw_f32"] = None
    resident = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                - mem["alias_size_in_bytes"])

    result.update({
        "ok": True,
        "price_s": round(price_s, 1),
        "memory": {**mem, "temp_size_in_bytes": None,
                   "peak_memory_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "resident_bytes_lower_bound": resident,
        "fits_lower_bound": resident <= hw.hbm_gb * 1e9,
        "cost": {"flops": per_dev["flops"], "bytes": per_dev["bytes"],
                 "global_flops": cost["flops"],
                 "global_bytes": cost["bytes"],
                 "unknown_trip_loops": cost["unknown_trip_loops"],
                 "bytes_by_kind": {k: v / n_chips for k, v in
                                   cost["bytes_by_kind"].items()}},
        "collectives": None,
        "priced_as": prog["priced_as"],
        "roofline": roof,
        "unseen": dict(UNSEEN),
        "hw": dataclasses.asdict(hw),
        "knobs": dict(knobs),
    })
    if verbose:
        print(f"== {arch} x {shape.name} on {result['mesh']} ==")
        print("per-device bytes:", {k: v for k, v in result["memory"].items()
                                    if v is not None},
              "fits (lower bound):", result["fits_lower_bound"])
        print("flops/bytes per device:", per_dev["flops"], per_dev["bytes"])
        print("roofline:", json.dumps(roof["seconds"]),
              "bottleneck:", roof["bottleneck"],
              "roofline_fraction:", roof.get("roofline_fraction"))
    return result


def _step(cfg, shape: ShapeSpec, opt_cfg):
    """(the step function of ``shape.kind``, its meta arguments)."""
    api = get_api(cfg)
    if shape.kind == "train":
        return (make_train_step(cfg, opt_cfg, api),
                (sp.train_state_struct(cfg, opt_cfg),
                 sp.input_specs(cfg, shape)))
    params = sp.param_struct(cfg)
    if shape.kind == "prefill":
        return make_prefill(cfg, api), (params, sp.input_specs(cfg, shape),
                                        _max_len(cfg, shape))
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return make_decode_step(cfg, api), (
        params, token, pos, sp.decode_cache_struct(cfg, b, shape.seq_len))


def _max_len(cfg, shape: ShapeSpec) -> int:
    # vlm prepends n_patches positions to the text tokens
    return shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)


# A segment repeated more often than this is priced at 2 and 3 repeats and
# extrapolated, as the reference's analyzer prices a scanned segment's body
# once and multiplies it by the trip count.
_PRICED_REPEATS = 4


def _variants(cfg, shape: ShapeSpec) -> list:
    """(config, shape, weight) triples whose weighted costs sum to the
    step's, each cheaper to run. Exact, because the cost is affine in each
    long segment's repeat count (the blocks of a segment are alike and run
    one after the other; the stacked caches and gradients grow with the
    count) and, for an attention-free stack of mLSTM / sLSTM layers, in the
    sequence length (the sLSTM steps token by token, the mLSTM chunk by
    chunk, for every length a multiple of the chunk above two chunks)."""
    long = [(field, i, seg.count)
            for field in ("segments", "encoder_segments")
            for i, seg in enumerate(getattr(cfg, field))
            if seg.count > _PRICED_REPEATS]

    def with_counts(counts: dict):
        out = {}
        for field in ("segments", "encoder_segments"):
            out[field] = tuple(
                dataclasses.replace(seg, count=counts.get((field, i),
                                                          seg.count))
                for i, seg in enumerate(getattr(cfg, field)))
        return dataclasses.replace(cfg, **out)

    base = {(f, i): 2 for f, i, _ in long}
    depth = [(with_counts(base), 1 - sum(n - 2 for *_, n in long))]
    depth += [(with_counts({**base, (f, i): 3}), n - 2) for f, i, n in long]

    kinds = {l.kind for seg in cfg.segments for l in seg.layers}
    chunk = cc.RUNTIME["mlstm_chunk"]
    if (shape.kind != "decode" and kinds <= {"mlstm", "slstm"}
            and not cfg.encoder_segments and chunk
            and shape.seq_len % chunk == 0 and shape.seq_len > 3 * chunk):
        alpha = (shape.seq_len - 2 * chunk) // chunk
        seq = [(dataclasses.replace(shape, seq_len=2 * chunk), 1 - alpha),
               (dataclasses.replace(shape, seq_len=3 * chunk), alpha)]
    else:
        seq = [(shape, 1)]
    return [(c, sh, wc * ws) for c, wc in depth for sh, ws in seq]


def _program(cfg, shape: ShapeSpec, opt_overrides) -> dict:
    """The step of ``shape.kind`` priced at global shapes (``_variants``:
    cheaper runs combined exactly), with its full-size meta arguments and
    outputs and what the per-device accounting needs. No logical rules are
    pushed: on meta tensors (not ``DTensor``s) ``logical_constraint``
    changes nothing."""
    total_params = _total_params(sp.param_struct(cfg))
    moment_dtype = "bfloat16" if total_params * 2 > 100e9 else "float32"
    opt_cfg = AdamWConfig(moment_dtype=moment_dtype, **(opt_overrides or {}))
    variants = _variants(cfg, shape)
    cost = {"flops": 0.0, "bytes": 0.0, "bytes_by_kind": {}}
    for cfg_v, shape_v, weight in variants:
        fn, args_v = _step(cfg_v, shape_v, opt_cfg)
        c, out_v = program_cost.measure(fn, *args_v)
        cost["flops"] += weight * c["flops"]
        cost["bytes"] += weight * c["bytes"]
        for k, v in c["bytes_by_kind"].items():
            cost["bytes_by_kind"][k] = cost["bytes_by_kind"].get(k, 0.0) \
                + weight * v
    cost["bytes_by_kind"] = dict(sorted(cost["bytes_by_kind"].items(),
                                        key=lambda kv: -kv[1]))
    cost.update(collectives=c["collectives"], unknown_trip_loops=0)
    _, args = _step(cfg, shape, opt_cfg)
    b = shape.global_batch
    if shape.kind == "train":       # (new state, metrics)
        out = (args[0], out_v[1])
    elif shape.kind == "prefill":   # (last logits, caches at max_len)
        out = (out_v[0], sp.decode_cache_struct(cfg, b, _max_len(cfg, shape)))
    else:                           # (next token, caches)
        out = (out_v[0], args[3])
    return {"active_params": active_params(cfg),
            "fsdp": total_params * 2 > _SERVE_FSDP_BYTES,
            "cost": cost, "args": args, "out": out,
            "priced_as": [{"seq_len": sh.seq_len, "weight": w,
                           "repeats": [seg.count for seg in c.segments]
                           + [seg.count for seg in c.encoder_segments]}
                          for c, sh, w in variants]}


def _memory(cfg, shape: ShapeSpec, prog: dict, mesh) -> dict:
    """Per-device argument, output and donated (aliased) bytes of a priced
    program placed on ``mesh`` by the reference's specs."""
    args, out = prog["args"], prog["out"]
    b = shape.global_batch
    if shape.kind == "train":
        rules = ShardingRules(mesh=mesh, fsdp=True)
        state_specs = sp.train_state_specs(rules, args[0])
        arg_specs = (state_specs, sp.batch_partition_specs(rules, args[1]))
        # (new state, metrics): the state donated and placed as it came,
        # the metrics replicated
        out_specs = (state_specs, P())
        donated = (args[0], state_specs)
    elif shape.kind == "prefill":
        rules = ShardingRules(mesh=mesh, fsdp=prog["fsdp"])
        arg_specs = (sp.param_specs(rules, args[0]),
                     sp.batch_partition_specs(rules, args[1]), P())
        # last logits split like the tokens, caches as the decode places them
        out_specs = (P(*sp.token_specs(rules, b), None),
                     sp.decode_cache_specs(rules, cfg, b,
                                           _max_len(cfg, shape)))
        donated = None
    else:
        act_rules = SEQ_PARALLEL_ACT_RULES if b < 8 else None
        rules = ShardingRules(mesh=mesh, fsdp=prog["fsdp"],
                              act_rules=act_rules)
        token_spec = sp.token_specs(rules, b)
        cache_specs = sp.decode_cache_specs(rules, cfg, b, shape.seq_len)
        arg_specs = (sp.param_specs(rules, args[0]), token_spec, P(),
                     cache_specs)
        out_specs = (token_spec, cache_specs)
        donated = (args[3], cache_specs)

    def placed(trees, specs) -> int:
        return sum(_per_device_bytes(t, s, mesh) for t, s in zip(trees, specs)
                   if not isinstance(t, int))

    return {
        "argument_size_in_bytes": placed(args, arg_specs),
        "output_size_in_bytes": placed(out, out_specs),
        "alias_size_in_bytes": (_per_device_bytes(*donated, mesh)
                                if donated else 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--q-chunk", type=int, default=256)
    ap.add_argument("--ssm-chunk", type=int, default=256)
    ap.add_argument("--mlstm-chunk", type=int, default=256)
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    knobs = _knob_defaults(args)

    results = []
    n_fail = 0
    for arch in archs:
        programs: dict = {}        # each program priced once for both meshes
        for shape_name in shapes:
            for mp in meshes:
                try:
                    r = run_cell(arch, shape_name, mp, knobs,
                                 programs=programs)
                except Exception as e:  # a cell failure is a bug — surface it
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape_name,
                         "mesh": "2x16x16" if mp else "16x16",
                         "error": repr(e)}
                    n_fail += 1
                results.append(r)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    name = f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
                    with open(os.path.join(args.out, name), "w") as f:
                        json.dump(r, f, indent=1)
    ok = sum(1 for r in results if r.get("ok"))
    skipped = sum(1 for r in results if "skipped" in r)
    print(f"\nDRYRUN SUMMARY: {ok} ok, {skipped} skipped, {n_fail} failed, "
          f"{len(results)} total")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
