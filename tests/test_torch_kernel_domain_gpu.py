"""Every input the reference's kernel functions take, on the card, against
the plain versions. Imports no JAX, so that it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel_domain_gpu.py

* head dims past 256 (``WIDE_DIMS``, run in column passes of 256) in fp32,
  bf16 and fp16: the flash forward (causal, and with window 64), its
  backward through ``ops.FlashAttention`` and decode against a ring-stale
  cache, at B 2, S = T = 256 (128 at D 1024), GQA group 2;
* fp16 at the head dims the kernels already took (``F16_DIMS``) on the same
  calls, and ``gcn_spmm``'s ``spmm`` / ``scaled_spmm`` at buckets 64 and
  1024;
* views (a transpose, a column slice, a 2-byte tensor 2 bytes off the
  16-byte grid) on every kernel, each bit for bit the contiguous call;
* ``spmm`` / ``scaled_spmm`` with an fp32 adjacency and bf16 features;
* query rows that see no key (S 12, T 6, window 2, causal and not),
  forward and backward, in all three dtypes;
* past 256, ragged S and T (with no-key rows), GQA groups 1 and 7
  (``WIDE_SHAPES``).

Tolerances: 2e-5 fp32 and 2e-2 bf16 (``tests/test_kernels.py``), 1e-2
fp16 (3 more mantissa bits than bf16). Every case must launch its kernel.
``chip_smoke.py``'s ``kernel_domain`` phase runs the same cases. Without a
CUDA card every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.decode_attention import ref as tdec_ref
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.gcn_spmm import kernel as tspmm
from repro_torch.kernels.gcn_spmm import ops as tspmm_ops
from repro_torch.kernels.gcn_spmm import ref as tspmm_ref

WIDE_DIMS = (257, 320, 384, 512, 576, 1024)
F16_DIMS = (36, 96, 256)
DTYPES = ("float32", "bfloat16", "float16")
WINDOWS = (None, 64)
B, S, H, KV = 2, 256, 4, 2     # S = T; GQA group 2
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 1e-2}
SPMM_BUCKETS = (64, 1024)
SPMM_D = 213                   # the planner's GNN hidden width
NOKEY = dict(s=12, t=6, window=2, d=64)   # rows 7.. see no key under the window
# (head dim, dtype): the wide dims in every dtype, fp16 at the others
DIM_DTYPES = [(d, dt) for d in WIDE_DIMS for dt in DTYPES] \
    + [(d, "float16") for d in F16_DIMS]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def seq_len(d):
    return 128 if d >= 1024 else S


def _normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))


def inputs(d, dtype, seed=0, s=None, t=None):
    """q (B, S, H, D), k, v (B, T, KV, D), dO like q, on the card in
    ``dtype``, from a seeded numpy generator."""
    s = seq_len(d) if s is None else s
    t = s if t is None else t
    rng = np.random.default_rng(seed)
    return [_normal(rng, shape, dtype)
            for shape in ((B, s, H, d), (B, t, KV, d), (B, t, KV, d), (B, s, H, d))]


def ring_valid(t, device="cuda"):
    """A ring cache mid-wrap: the valid slots are not a prefix
    (``tests/test_torch_head_dims_gpu.py::ring_valid``)."""
    newest, pos = 3 * t + 7, 3 * t - 100
    slot_pos = np.full((t,), -1, np.int64)
    for p in range(newest + 1):
        slot_pos[p % t] = p
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - t)
    return torch.from_numpy(valid).to(device)


# -- the calls, each -> (kernel result, plain result) -------------------------

def forward_case(d, dtype, window, causal=True, s=None, t=None):
    q, k, v, _ = inputs(d, dtype, s=s, t=t)
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    return got, tflash_ref.attention_ref(q, k, v, causal=causal, window=window)


def backward_case(d, dtype, window, causal=True, s=None, t=None):
    """dO through ``ops.flash_attention`` on inputs that require grad
    (``FlashAttention``: forward kernel with the log-sum-exp, then the
    backward kernel) against the plain version's autograd."""
    q, k, v, do = inputs(d, dtype, seed=1, s=s, t=t)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(o, leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ref.attention_ref(*leaves, causal=causal, window=window)
    return got, torch.autograd.grad(o, leaves, do)


def decode_case(d, dtype):
    q, k, v, _ = inputs(d, dtype, seed=2)
    q, valid = q[:, :1].contiguous(), ring_valid(k.shape[1])
    return tdec.decode_attention(q, k, v, valid), \
        tdec_ref.decode_attention_ref(q, k, v, valid)


def spmm_inputs(n, dtype, seed=3, adj_dtype=None):
    """A GCN aggregation at bucket n: a 0/1 adjacency with self loops
    (``adj_dtype``, else ``dtype``), features (n, 213), row and column
    scales, as the planner normalises them."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    deg = a.sum(1)
    adj = torch.from_numpy(a).to("cuda", getattr(torch, adj_dtype or dtype))
    feats = _normal(rng, (n, SPMM_D), dtype)
    r = torch.from_numpy((deg ** -0.5).astype(np.float32)).to("cuda", getattr(torch, dtype))
    return adj, feats, r, r.clone()


def spmm_case(n, dtype, scaled, adj_dtype=None):
    """``ops.spmm`` / ``ops.scaled_spmm`` against the plain version (the
    scales cast to the features' type first, as the ops do)."""
    adj, feats, r, c = spmm_inputs(n, dtype, adj_dtype=adj_dtype)
    if scaled:
        return tspmm_ops.scaled_spmm(adj, feats, r, c), \
            tspmm_ref.scaled_spmm_ref(adj, feats, r, c)
    return tspmm_ops.spmm(adj, feats), tspmm_ref.spmm_ref(adj, feats)


def nokey_case(dtype, causal, backward):
    """S 12, T 6, window 2: the rows from T + window - 1 = 7 on see no key
    and are the uniform average over the 6 keys (backward: dO / 6 to every
    key's dV, nothing to dQ and dK)."""
    c = NOKEY
    fn = backward_case if backward else forward_case
    return fn(c["d"], dtype, c["window"], causal=causal, s=c["s"], t=c["t"])


# -- views: each kernel call on views against the same call on dense copies --

def view_of(x, kind):
    """A view holding ``x``'s values: "transposed" (stored with its last two
    leading axes swapped), "sliced" (the first columns of a wider tensor),
    "unbind" (one of two tensors fused on a new axis before the last) or
    "offset" (one element past the start of a flat buffer: 2 bytes off the
    16-byte grid in a 2-byte type)."""
    if kind == "transposed":
        return x.transpose(-2, -3).contiguous().transpose(-2, -3)
    if kind == "unbind":
        return torch.stack([torch.zeros_like(x), x], dim=-2).unbind(-2)[1]
    if kind == "sliced":
        wide = torch.zeros((*x.shape[:-1], x.shape[-1] + 8), dtype=x.dtype,
                           device=x.device)
        wide[..., :x.shape[-1]] = x
        return wide[..., :x.shape[-1]]
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


VIEWS = ("transposed", "sliced", "unbind", "offset")
VIEW_KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
                "scaled_spmm")


def view_copies(kernel, kind) -> bool:
    """Whether the wrapper copies the view: the attention kernels read
    every view with a unit-stride last axis on the 16-byte grid through its
    strides and copy the offset one; ``gcn_spmm`` reads dense tensors, at
    any address."""
    if kernel == "scaled_spmm":
        return kind != "offset"
    return kind == "offset"


def view_case(kernel, kind, dtype="bfloat16", d=None):
    """(call on views, call on dense copies of the same values), which must
    be equal bit for bit, whether the view was what it claims (not dense,
    or off the grid), and whether the wrapper's ``dispatch`` copies it; at
    head dim ``d`` (default 96 for flash, 64 for decode)."""
    if kernel == "scaled_spmm":
        adj, feats, r, c = spmm_inputs(64, dtype)
        if kind == "transposed":   # a square adjacency stored transposed
            adj_v = adj.t().contiguous().t()
            args_v = (adj_v, view_of(feats, "sliced"), r, c)
        else:
            args_v = (view_of(adj, kind), view_of(feats, kind), r, c)
        args = [x.contiguous() for x in args_v]
        fn = lambda *a: tspmm.scaled_spmm(*a)
        copy = tspmm.dispatch(args_v[1].dtype, args_v)["copy"][:2]
    elif kernel == "decode_attention":
        d = d or 64
        q, k, v, _ = inputs(d, dtype, seed=4, s=128)
        q = q[:, :1].contiguous()
        valid = ring_valid(128)
        args_v = (view_of(q, kind) if kind != "transposed" else q,
                  view_of(k, kind), view_of(v, kind), valid)
        args = [x.contiguous() for x in args_v]
        fn = tdec.decode_attention
        copy = tdec.dispatch(d, args_v)["copy"][1:3]
    else:
        d = d or 96
        q, k, v, do = inputs(d, dtype, seed=5, s=128)
        o, lse = tflash.flash_attention(q, k, v, return_lse=True)
        if kernel == "flash_attention":
            args_v = tuple(view_of(x, kind) for x in (q, k, v))
            fn = tflash.flash_attention
            copy = tflash.dispatch(d, q.dtype, args_v)["copy"]
        else:
            args_v = (*(view_of(x, kind) for x in (q, k, v, o)), lse,
                      view_of(do, kind))
            fn = tflash.flash_attention_bwd
            copy = tflash.dispatch(d, q.dtype, args_v[:4] + args_v[5:],
                                          backward=True)["copy"]
        args = [x.contiguous() for x in args_v]
    got, want = fn(*args_v), fn(*args)
    odd = [x for x in args_v if not x.is_contiguous() or x.data_ptr() % 16]
    assert len(set(copy)) == 1, f"{kernel} {kind}: mixed copies {copy}"
    return got, want, bool(odd), copy[0]


def launch_counts() -> dict:
    return {**tflash.LAUNCHES, **tdec.LAUNCHES, **tspmm.LAUNCHES}


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _run(fn, dtype, want_launches):
    """Run one case, check it launched each of ``want_launches`` and agrees
    with its plain version."""
    before = launch_counts()
    got, want = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    for name in want_launches:
        assert after[name] > before[name], name
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d, dtype", DIM_DTYPES)
def test_forward(d, dtype, window):
    _need_cuda()
    _run(lambda: forward_case(d, dtype, window), dtype, ["flash_attention"])


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d, dtype", DIM_DTYPES)
def test_backward(d, dtype, window):
    _need_cuda()
    _run(lambda: backward_case(d, dtype, window), dtype,
         ["flash_attention", "flash_attention_bwd"])


@pytest.mark.gpu
@pytest.mark.parametrize("d, dtype", DIM_DTYPES)
def test_decode(d, dtype):
    _need_cuda()
    _run(lambda: decode_case(d, dtype), dtype, ["decode_attention"])


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", (False, True))
@pytest.mark.parametrize("n", SPMM_BUCKETS)
def test_gcn_spmm_float16(n, scaled):
    _need_cuda()
    _run(lambda: spmm_case(n, "float16", scaled), "float16",
         ["scaled_spmm" if scaled else "spmm"])


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", (False, True))
@pytest.mark.parametrize("n", SPMM_BUCKETS)
def test_gcn_spmm_fp32_adjacency_bf16_features(n, scaled):
    _need_cuda()
    _run(lambda: spmm_case(n, "bfloat16", scaled, adj_dtype="float32"),
         "bfloat16", ["scaled_spmm" if scaled else "spmm"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("kernel", VIEW_KERNELS)
def test_views_equal_the_dense_call(kernel, kind):
    _need_cuda()
    got, want, odd, copied = view_case(kernel, kind)
    torch.cuda.synchronize()
    assert odd, "the view case built a dense, aligned view"
    assert copied == view_copies(kernel, kind)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", (64, 256))
@pytest.mark.parametrize("kernel", VIEW_KERNELS[:3])
def test_views_at_full_widths_equal_the_dense_call(kernel, d, dtype):
    """A head dim that fills its width: the dense call runs the body with
    the width at compile time, the view (read in place) the one with the
    head dim at run time and the caller's strides; the two agree bit for
    bit."""
    _need_cuda()
    got, want, odd, copied = view_case(kernel, "transposed", dtype, d=d)
    torch.cuda.synchronize()
    assert odd and not copied
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("backward", (False, True))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_that_see_no_key(dtype, causal, backward):
    _need_cuda()
    _run(lambda: nokey_case(dtype, causal, backward), dtype,
         ["flash_attention"] + (["flash_attention_bwd"] if backward else []))


# past 256 at other shapes: (B, S, T, H, KV, D, causal, window, dtype) --
# ragged S and T (a causal window with S > T: rows from T + window - 1 on
# see no key), GQA group 1 and group 7
WIDE_SHAPES = [
    (1, 70, 45, 4, 2, 300, False, None, "bfloat16"),
    (1, 70, 45, 4, 2, 300, True, 16, "bfloat16"),
    (1, 70, 45, 4, 2, 300, True, 16, "float32"),
    (2, 64, 64, 4, 4, 320, True, None, "float16"),
    (1, 96, 96, 7, 1, 320, True, None, "bfloat16")]


def wide_shape_inputs(case, seed=8):
    b, s, t, h, kv, d, _, _, dtype = case
    rng = np.random.default_rng(seed)
    return [_normal(rng, shape, dtype)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE_SHAPES)
def test_wide_head_dims_at_other_shapes(case):
    _need_cuda()
    *_, causal, window, dtype = case
    q, k, v, do = wide_shape_inputs(case)

    def forward():
        return (tflash.flash_attention(q, k, v, causal=causal, window=window),
                tflash_ref.attention_ref(q, k, v, causal=causal, window=window))

    def backward():
        grads = []
        for fn in (tflash_ops.flash_attention, tflash_ref.attention_ref):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves, causal=causal, window=window)
            grads.append(torch.autograd.grad(o, leaves, do))
        return tuple(grads)

    def decode():
        q1, valid = q[:, :1].contiguous(), ring_valid(k.shape[1])
        return (tdec.decode_attention(q1, k, v, valid),
                tdec_ref.decode_attention_ref(q1, k, v, valid))

    _run(forward, dtype, ["flash_attention"])
    _run(backward, dtype, ["flash_attention", "flash_attention_bwd"])
    _run(decode, dtype, ["decode_attention"])
