"""The port's Mixture-of-Experts against the reference, on CPU, fp32.

``reduce_for_smoke(olmoe-1b-7b)``'s MoE (4 experts, top-2, d_ff_expert 32,
d 32), and deepseek-v2's (the same with one shared expert). The reference's
``init_moe`` params are carried across through numpy, so both packages run
the same weights on the same numpy inputs. Routing is compared exactly:
``gate_idx`` (the reference's ``jax.lax.top_k`` of the router softmax), the
dispatch tensor (which shows every capacity drop token for token), then
combine, aux and the layer outputs at the tolerances below."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro_torch import configs as tconfigs
from repro_torch._tree import tensor_from_numpy
from repro_torch.models import mlp as tmlp

from _torch_parity import runtime

# gate weights: one softmax and one division in each package, a few ulps
GATE_TOL = 1e-6
# layer outputs and aux: tests/test_kernels.py's fp32 tolerance
MOE_TOL = 2e-5


def _spec(arch):
    cfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    layer = cfg.segments[-1].layers[-1]
    tspec = tconfigs.reduce_for_smoke(tconfigs.get_config(arch)) \
        .segments[-1].layers[-1].moe
    assert dataclasses.asdict(layer.moe) == dataclasses.asdict(tspec)
    return layer.moe, tspec, cfg.d_model


def _params(spec, d, seed=0):
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), spec, d, "silu", jnp.float32)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    return jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _ref_top(router, x, k):
    """The reference's gate_idx (``jax.lax.top_k`` of the router softmax)
    and each token's margin, the least gap between neighbours among its
    k + 1 largest probabilities."""
    probs = jax.nn.softmax(jnp.einsum("...d,de->...e", jnp.asarray(x), router),
                           -1)
    vals, idx = jax.lax.top_k(probs, k + 1)
    return (np.asarray(idx[..., :k]),
            np.asarray(jnp.min(vals[..., :-1] - vals[..., 1:], axis=-1)))


def _check_route(jp, tp, jspec, tspec, x, capacity, combine_tol=GATE_TOL):
    spec = tspec
    jd, jc, jaux = jmlp._route(jp["router"], jnp.asarray(x), jspec, capacity)
    decisions = []
    td, tc, taux = tmlp._route(tp["router"], torch.from_numpy(x), tspec,
                               capacity, decisions)
    (gate_idx, keep, margin), = decisions
    want_idx, want_margin = _ref_top(jp["router"], x, spec.top_k)
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    _close(margin, want_margin, GATE_TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.shape == (x.shape[0], x.shape[1], spec.n_experts, capacity)
    # a choice is kept exactly where it reaches the dispatch tensor
    hit = np.take_along_axis(np.asarray(jd).any(-1), gate_idx.numpy(), axis=-1)
    np.testing.assert_array_equal(keep.numpy(), hit)
    _close(tc, jc, combine_tol)
    _close(taux, jaux, MOE_TOL)
    return keep


@pytest.mark.parametrize("capacity", [3, 10, 64])
def test_route_matches_reference_with_and_without_drops(capacity):
    """G 2 groups of 32 tokens, 4 experts, top-2 (16 choices an expert on
    average): capacity 3 and 10 drop choices, 64 drops none."""
    jspec, spec, d = _spec("olmoe-1b-7b")
    jp, tp = _params(jspec, d)
    keep = _check_route(jp, tp, jspec, spec, _x((2, 32, d), 1), capacity)
    assert bool(keep.all()) == (capacity == 64)


def test_route_breaks_ties_by_lower_expert_index():
    """Experts 1 and 2 share a router column (and 0 and 3 another), so every
    token's probabilities tie in pairs: the order of the top-k, and with it
    which choice takes a slot first, must be the reference's."""
    jspec, spec, d = _spec("olmoe-1b-7b")
    jp, tp = _params(jspec, d)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    keep = _check_route(jp, tp, jspec, spec, _x((1, 32, d), 2), 12)
    assert not bool(keep.all())


def test_route_bf16_combine_matches_reference():
    jspec, spec, d = _spec("olmoe-1b-7b")
    jp, tp = _params(jspec, d)
    with runtime(moe_combine_bf16=True):
        _check_route(jp, tp, jspec, spec, _x((2, 32, d), 3), 10, combine_tol=0.0)


# path -> (B, S, seq_chunk, decode): one group of 64 tokens (n <= 256: no
# dropping); one of 512 (capacity int(512 x 2 / 4 x 1.25) = 320); the
# chunked path (a group per batch row, 4 chunks of 16); a decode step
PATHS = {"unchunked": (2, 32, 0, False), "unchunked_n512": (2, 256, 0, False),
         "chunked": (2, 64, 16, False), "decode": (4, 1, 16, True)}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_matches_reference(arch, path):
    jspec, spec, d = _spec(arch)
    assert spec.n_shared == (1 if arch.startswith("deepseek") else 0)
    jp, tp = _params(jspec, d, seed=4)
    b, s, chunk, decode = PATHS[path]
    x = _x((b, s, d), 5)
    yj, auxj = jmlp.moe(jp, jspec, jnp.asarray(x), "silu", seq_chunk=chunk,
                        decode=decode)
    with tmlp.record_routing() as rec:
        yt, auxt = tmlp.moe(tp, spec, torch.from_numpy(x), "silu",
                            seq_chunk=chunk, decode=decode)
    (gate_idx, keep, margin), = rec
    assert gate_idx.shape == keep.shape == (b, s, spec.top_k)
    assert margin.shape == (b, s)
    want_idx, want_margin = _ref_top(jp["router"], x, spec.top_k)
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    _close(margin, want_margin, GATE_TOL)
    _close(yt, yj, MOE_TOL)
    _close(auxt, auxj, MOE_TOL)


def test_moe_capacity_drops_match_reference():
    """The counterpart of test_chunked_exec.py::test_moe_capacity_drops_tokens
    at its shapes (2 x 512 tokens, d 16, capacity factor 0.5): drops happen,
    and they are the reference's, token for token."""
    from repro.configs.base import MoESpec as JSpec
    from repro_torch.configs.base import MoESpec as TSpec
    kw = dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=0.5)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jp = jmlp.init_moe(jax.random.PRNGKey(14), jspec, 16, "silu", jnp.float32)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    x = _x((2, 512, 16), 15)
    capacity = int(1024 * 2 / 4 * 0.5)
    keep = _check_route(jp, tp, jspec, tspec, x.reshape(1, 1024, 16), capacity)
    assert 0 < int((~keep).sum()) < keep.numel()
    yj, auxj = jmlp.moe(jp, jspec, jnp.asarray(x), "silu")
    yt, auxt = tmlp.moe(tp, tspec, torch.from_numpy(x), "silu")
    assert torch.isfinite(yt).all()
    _close(yt, yj, MOE_TOL)
    _close(auxt, auxj, MOE_TOL)


def test_moe_chunked_equals_full_without_drops():
    """test_chunked_exec.py::test_moe_chunked_matches_full on the port."""
    from repro_torch.configs.base import MoESpec
    spec = MoESpec(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(12)
    p = tmlp.init_moe(gen, spec, 16, "silu", torch.float32)
    x = torch.from_numpy(_x((2, 64, 16), 13))
    y_full, _ = tmlp.moe(p, spec, x, "silu", seq_chunk=0)
    y_chunk, _ = tmlp.moe(p, spec, x, "silu", seq_chunk=16)
    _close(y_chunk, y_full.numpy(), MOE_TOL)


def test_moe_knobs_match_reference():
    """``moe_chunk`` and ``moe_capacity_factor`` override the config's chunk
    and the chunked path's capacity factor; ``moe_combine_bf16`` runs the
    routing tensors in bf16."""
    jspec, spec, d = _spec("olmoe-1b-7b")
    jp, tp = _params(jspec, d, seed=6)
    x = _x((2, 64, d), 7)
    for knobs in ({"moe_chunk": 16, "moe_capacity_factor": 0.5},
                  {"moe_combine_bf16": True}):
        with runtime(**knobs):
            yj, auxj = jmlp.moe(jp, jspec, jnp.asarray(x), "silu")
            yt, auxt = tmlp.moe(tp, spec, torch.from_numpy(x), "silu")
        _close(yt, yj, MOE_TOL)
        _close(auxt, auxj, MOE_TOL)


def test_moe_gradients_match_reference():
    """The chunked path under checkpoint, differentiated: every param's
    gradient of sum(y^2) + aux."""
    jspec, spec, d = _spec("deepseek-v2-236b")
    jp, tp = _params(jspec, d, seed=8)
    x = _x((2, 32, d), 9)

    def jloss(p):
        y, aux = jmlp.moe(p, jspec, jnp.asarray(x), "silu", seq_chunk=16)
        return jnp.sum(y ** 2) + aux

    gj = jax.grad(jloss)(jp)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    y, aux = tmlp.moe(tp, spec, torch.from_numpy(x), "silu", seq_chunk=16)
    ((y ** 2).sum() + aux).backward()
    for g, t in zip(jax.tree.leaves(gj), jax.tree.leaves(tp)):
        _close(t.grad, g, 1e-4)
