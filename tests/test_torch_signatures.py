"""The port's public signatures take the reference's parameter names.

An AST walk of both trees: every public function of a module of
``src/repro/`` (and every public method of its public classes) has a
counterpart of the same name in the same module of ``src/repro_torch/``,
and that counterpart takes each of the reference's parameter names. One case
per reference module, so each counts. The recorded exceptions, and nothing
else, are:

* ``key`` (a ``jax.random`` key) in the inits: the port draws from a
  ``torch.Generator`` (``gen``) or a ``seed``;
* ``launch/dryrun.py::run_cell``'s ``save_hlo``: the port prices an eager
  program and has no HLO to save;
* the Pallas entry points of the three ``kernel.py`` files, which the CUDA
  entry points replace.

Then the reference keywords the walk once found missing, in use: the kernel
ops' ``force_ref``, ``block_q`` and ``block_kv`` against the reference
called with the same keywords (on the CPU both sides' ``force_ref`` run the
plain oracles; without it the reference runs its Pallas kernels in
interpret mode), and ``make_decode_step(cfg, greedy=True)``'s tokens
against the reference's at a reduced config."""
import ast
import dataclasses
import pathlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.kernels.decode_attention import ops as jdec
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.gcn_spmm import ops as jspmm
from repro.models import decoder_lm as jdlm
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.gcn_spmm import kernel as tspmm_kernel
from repro_torch.kernels.gcn_spmm import ops as tspmm
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import train_step as tts

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

KEY_NAMES = ("gen", "seed")   # what the port's inits draw from instead of `key`
# (module, function) -> reference parameter -> names the port takes instead
RENAMED = {
    ("core/gnn.py", "init"): {"key": KEY_NAMES},
    ("models/attention.py", "init_attn"): {"key": KEY_NAMES},
    ("models/attention.py", "init_mla"): {"key": KEY_NAMES},
    ("models/common.py", "truncnorm_init"): {"key": KEY_NAMES},
    ("models/common.py", "dense_init"): {"key": KEY_NAMES},
    ("models/decoder_lm.py", "init_layer"): {"key": KEY_NAMES},
    ("models/decoder_lm.py", "init_block"): {"key": KEY_NAMES},
    ("models/decoder_lm.py", "init_params"): {"key": KEY_NAMES},
    ("models/encdec.py", "init_params"): {"key": KEY_NAMES},
    ("models/mlp.py", "init_mlp"): {"key": KEY_NAMES},
    ("models/mlp.py", "init_moe"): {"key": KEY_NAMES},
    ("models/ssm.py", "init_mamba"): {"key": KEY_NAMES},
    ("models/vlm.py", "init_params"): {"key": KEY_NAMES},
    ("models/xlstm.py", "init_mlstm"): {"key": KEY_NAMES},
    ("models/xlstm.py", "init_slstm"): {"key": KEY_NAMES},
    ("training/train_step.py", "init_train_state"): {"key": KEY_NAMES},
}
DROPPED = {("launch/dryrun.py", "run_cell"): {"save_hlo"}}
PALLAS_ENTRY_POINTS = {
    ("kernels/gcn_spmm/kernel.py", "spmm_blocked"),
    ("kernels/gcn_spmm/kernel.py", "scaled_spmm_blocked"),
    ("kernels/flash_attention/kernel.py", "flash_attention_bhsd"),
    ("kernels/decode_attention/kernel.py", "decode_attention_grouped"),
}


def _public_defs(path: pathlib.Path) -> dict:
    """name -> FunctionDef of the module's public functions and its public
    classes' public methods (``Class.method``; ``__init__`` and
    ``__call__`` count as public)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not m.name.startswith("_")
                        or m.name in ("__init__", "__call__")):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _param_names(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs] \
        + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def test_the_walk_sees_the_whole_reference():
    assert len(REF_MODULES) > 80
    assert sum(len(_public_defs(REF / m)) for m in REF_MODULES) > 400


@pytest.mark.parametrize("module", REF_MODULES)
def test_port_takes_every_reference_parameter(module):
    assert (PORT / module).exists(), f"no port of {module}"
    ref, port = _public_defs(REF / module), _public_defs(PORT / module)
    gaps = []
    for name, fn in ref.items():
        if (module, name) in PALLAS_ENTRY_POINTS:
            assert name not in port, f"{module}::{name} is recorded as replaced"
            continue
        if name not in port:
            gaps.append(f"{name} missing")
            continue
        have = set(_param_names(port[name]))
        renamed = RENAMED.get((module, name), {})
        dropped = DROPPED.get((module, name), set())
        for p in _param_names(fn):
            if p in dropped:
                continue
            if p in renamed:
                if not have & set(renamed[p]):
                    gaps.append(f"{name}({p}) takes none of {renamed[p]}")
            elif p not in have:
                gaps.append(f"{name}({p})")
    assert not gaps, f"{module}: {gaps}"


def test_recorded_exceptions_are_still_needed():
    """Each recorded rename or drop is a real difference: the port really
    lacks the reference's name there."""
    for (module, name), renamed in {**RENAMED, **{
            k: {p: () for p in v} for k, v in DROPPED.items()}}.items():
        ref, port = _public_defs(REF / module), _public_defs(PORT / module)
        for p in renamed:
            assert p in _param_names(ref[name]), (module, name, p)
            assert p not in _param_names(port[name]), (module, name, p)


# -- the kernels' keywords -----------------------------------------------------

def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flash_inputs(d=32, s=72, seed=0):
    return _normal((2, s, 4, d), seed), _normal((2, s, 2, d), seed + 1), \
        _normal((2, s, 2, d), seed + 2)


@pytest.mark.parametrize("window", (None, 16))
def test_flash_force_ref_matches_the_reference_force_ref(window):
    q, k, v = _flash_inputs()
    launches = dict(tflash_kernel.LAUNCHES)
    want = jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  window=window, force_ref=True)
    got = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 window=window, force_ref=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(got, tflash_ref.attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), window=window))
    assert tflash_kernel.LAUNCHES == launches


@pytest.mark.parametrize("block_q,block_kv", ((16, 32), (64, 8), (512, 512)))
def test_flash_block_sizes_match_the_reference_with_the_same_blocks(block_q,
                                                                    block_kv):
    q, k, v = _flash_inputs(seed=3)
    want = jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  window=24, block_q=block_q, block_kv=block_kv)
    got = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 window=24, block_q=block_q, block_kv=block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("block_kv", (8, 64, 512))
@pytest.mark.parametrize("force_ref", (False, True))
def test_decode_keywords_match_the_reference(block_kv, force_ref):
    q = _normal((2, 1, 4, 40), 6)
    k, v = _normal((2, 100, 2, 40), 7), _normal((2, 100, 2, 40), 8)
    valid = np.arange(100) % 7 != 3
    launches = dict(tdec_kernel.LAUNCHES)
    want = jdec.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 jnp.asarray(valid), block_kv=block_kv,
                                 force_ref=force_ref)
    got = tdec.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.from_numpy(valid), block_kv=block_kv,
                                force_ref=force_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert tdec_kernel.LAUNCHES == launches


@pytest.mark.parametrize("block", (0, -8, 2.0, True, None))
def test_bad_block_sizes_are_refused(block):
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(s=16))
    with pytest.raises(ValueError, match="block_q must be a positive int"):
        tflash.flash_attention(q, k, v, block_q=block)
    with pytest.raises(ValueError, match="block_kv must be a positive int"):
        tflash.flash_attention(q, k, v, block_kv=block)
    with pytest.raises(ValueError, match="block_kv must be a positive int"):
        tdec.decode_attention(q[:, :1], k, v, torch.ones(16, dtype=torch.bool),
                              block_kv=block)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("force_ref", (False, True))
def test_spmm_force_ref_matches_the_reference(dtype, force_ref):
    rng = np.random.default_rng(11)
    adj = (rng.random((30, 30)) < 0.2).astype(np.float32)
    feats = rng.standard_normal((30, 20)).astype(np.float32)
    r, c = rng.random(30).astype(np.float32), rng.random(30).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    launches = dict(tspmm_kernel.LAUNCHES)
    for jfn, tfn, extra in ((jspmm.spmm, tspmm.spmm, ()),
                            (jspmm.scaled_spmm, tspmm.scaled_spmm, (r, c))):
        want = jfn(jnp.asarray(adj, jdt), jnp.asarray(feats, jdt),
                   *(jnp.asarray(x) for x in extra), force_ref=force_ref)
        got = tfn(torch.from_numpy(adj).to(tdt), torch.from_numpy(feats).to(tdt),
                  *(torch.from_numpy(x) for x in extra), force_ref=force_ref)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    assert tspmm_kernel.LAUNCHES == launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_flash_force_ref_goes_through_the_local_heads_on_a_mesh():
    """``force_ref`` with ``DTensor`` inputs runs the plain version on each
    rank's local heads, as the kernel path does: a one-rank gloo mesh, heads
    split over it, against the plain version on whole tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(d=40, s=24, seed=5))
    want = tflash_ref.attention_ref(q, k, v, window=8)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,))
        qd, kd, vd = (distribute_tensor(x, mesh, [Shard(2)]) for x in (q, k, v))
        got = tflash.flash_attention(qd, kd, vd, window=8, force_ref=True)
        assert got.placements == (Shard(2),)
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


# -- make_decode_step(greedy=) ------------------------------------------------

@pytest.mark.parametrize("greedy", (True, False))
def test_decode_step_greedy_keyword_matches_the_reference(greedy):
    """Reduced phi3-mini (head_dim 16, fp32), the reference's params carried
    over: a prefill, then 5 steps of each package's ``make_decode_step(cfg,
    greedy=...)`` feeding its own tokens. The reference never reads
    ``greedy`` (both values give the argmax), nor does the port."""
    reduce = lambda pkg: dataclasses.replace(
        pkg.reduce_for_smoke(pkg.get_config("phi3-mini-3.8b")), remat=False,
        dtype="float32")
    jcfg, tcfg = reduce(jconfigs), reduce(tconfigs)
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 7),
                                               dtype=np.int32)
    n, max_len = 5, 7 + 5
    _, cj = jdlm.prefill(jp, jcfg, tokens=jnp.asarray(tokens), max_len=max_len)
    lt, ct = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(tokens),
                          max_len=max_len)
    jstep = jax.jit(jts.make_decode_step(jcfg, greedy=greedy))
    tstep = tts.make_decode_step(tcfg, greedy=greedy)
    first = torch.argmax(lt[:, -1], dim=-1).to(torch.int32)[:, None]
    jtok, ttok = jnp.asarray(first.numpy()), first
    jout, tout = [], []
    for i in range(n):
        jtok, cj = jstep(jp, jtok, jnp.int32(7 + i), cj)
        with torch.no_grad():
            ttok, ct = tstep(tp, ttok, 7 + i, ct)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    assert tout[0].dtype == np.int32
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
