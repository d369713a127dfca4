"""The graphed decode step on the card against the eager one. Imports no
JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_serve_gpu.py

On ``reduce_for_smoke(gemma3-1b)`` (14 layers, window-8 rings and full
caches), with the hand-written kernels on (``use_flash``): replays of the
captured step give the eager steps' tokens, logits and caches bit for bit,
and ``serve_batch`` counts the decode launches that ran. Without a CUDA card
every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import train_step as ttrain_step


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _setup(dtype: str, prompt: int, gen: int, seed: int = 0):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma3-1b")),
                              remat=False, dtype=dtype)
    params = tdlm.init_params(cfg, seed=seed, device="cuda")
    batch = make_batch(cfg, SyntheticConfig(global_batch=2, seq_len=prompt,
                                            seed=seed), 0)
    return cfg, params, torch.as_tensor(batch["tokens"], device="cuda"), batch


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in _leaves(v)]


@pytest.fixture
def flash_on():
    old = tcommon.RUNTIME["use_flash"]
    tcommon.RUNTIME["use_flash"] = True
    try:
        yield
    finally:
        tcommon.RUNTIME["use_flash"] = old


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_decode_matches_eager_steps(dtype, flash_on):
    """20 prompt tokens and 14 greedy steps (the window-8 rings wrap): the
    DecodeGraph's tokens and final caches equal the eager serve_step's."""
    _need_cuda()
    steps = 14
    cfg, params, tokens, _ = _setup(dtype, 20, steps + 1)
    step = ttrain_step.make_decode_step(cfg)
    with torch.no_grad():
        last, caches = tdlm.prefill(params, cfg, tokens=tokens,
                                    max_len=tokens.shape[1] + steps + 1)
        first = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
        eager_caches = _clone(caches)
        tok, eager = first, []
        for i in range(steps):
            tok, eager_caches = step(params, tok, tokens.shape[1] + i,
                                     eager_caches)
            eager.append(tok)
        graph = tserve.DecodeGraph(step, params, first, tokens.shape[1],
                                   caches, steps)
        for _ in range(steps):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.tokens, torch.cat(eager, dim=1))
        for a, b in zip(_leaves(caches), _leaves(eager_caches)):
            assert torch.equal(a, b)
        with pytest.raises(RuntimeError, match="holds columns"):
            graph.replay()
        graph.release()


@pytest.mark.gpu
def test_graphed_decode_step_logits_match_eager(flash_on):
    """decode_step itself captured with a tensor pos, teacher-forced: the
    replayed logits equal the eager logits at every step."""
    _need_cuda()
    cfg, params, tokens, _ = _setup("bfloat16", 12, 10, seed=1)
    s, steps = tokens.shape[1], 9
    fed = torch.randint(0, cfg.vocab_size, (2, steps), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0),
                        dtype=torch.int32)
    with torch.no_grad():
        _, caches = tdlm.prefill(params, cfg, tokens=tokens, max_len=s + steps)
        eager_caches = _clone(caches)
        tok = fed[:, :1].clone()
        pos = torch.full((), s, dtype=torch.int32, device="cuda")
        tdlm.decode_step(params, cfg, tok, pos, _clone(caches))   # eager warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = tdlm.decode_step(params, cfg, tok, pos, caches)
        for i in range(steps):
            tok.copy_(fed[:, i:i + 1])
            pos.fill_(s + i)
            graph.replay()
            want, eager_caches = tdlm.decode_step(params, cfg, fed[:, i:i + 1],
                                                  s + i, eager_caches)
            torch.cuda.synchronize()
            assert torch.equal(logits, want), f"step {i}"
        graph.reset()


@pytest.mark.gpu
def test_serve_batch_graphs_decode_and_counts_its_launches(flash_on):
    """On the card serve_batch decodes by replays: its tokens equal an eager
    greedy loop's; the decode launches are the warm-up step's and one
    step's worth per replay; decode_capture_s is reported."""
    _need_cuda()
    gen_n = 9
    cfg, params, tokens, batch = _setup("float32", 16, gen_n, seed=2)
    _graph.reset()
    gen, stats = tserve.serve_batch(cfg, params, batch, gen_n, log=lambda *_: None)
    assert tdec.LAUNCHES["decode_attention"] == cfg.n_layers * gen_n
    assert stats["decode_capture_s"] > 0 and stats["backend"] == "cuda"
    step = ttrain_step.make_decode_step(cfg)
    with torch.no_grad():
        last, caches = tdlm.prefill(params, cfg, tokens=tokens,
                                    max_len=tokens.shape[1] + gen_n)
        tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(gen_n - 1):
            tok, caches = step(params, tok, tokens.shape[1] + i, caches)
            out.append(tok)
    np.testing.assert_array_equal(gen, torch.cat(out, dim=1).cpu().numpy())


@pytest.mark.gpu
def test_serve_batch_releases_the_graph_memory(flash_on):
    """Repeated calls hold no more device memory than the first left."""
    _need_cuda()
    cfg, params, _, batch = _setup("bfloat16", 16, 6, seed=3)
    tserve.serve_batch(cfg, params, batch, 6, log=lambda *_: None)
    torch.cuda.synchronize()
    after_first = torch.cuda.memory_allocated()
    for _ in range(2):
        tserve.serve_batch(cfg, params, batch, 6, log=lambda *_: None)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= after_first
