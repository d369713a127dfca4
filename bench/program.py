"""The system under test: ``repro_torch``, driven as its users drive it.

The only module of the benchmark that imports the program. It builds the
program's configuration from a file under ``bench/configs``, hands it the
benchmark's weights in the program's own tree, and calls its entry points:
``launch.serve.serve_batch`` for serving, and for training the donating
step of ``training.train_step.make_train_step`` replayed by
``launch.train.TrainGraph``, fed by ``device_batch`` (what ``train_loop``
builds on the card, less its checkpoints).

The benchmark clocks the first token itself: around each ``serve_batch``
call it wraps the prefill function that ``serve_batch`` builds
(``make_prefill``, the boundary between the serving loop and the model),
waits for the device when the prefill returns, and reads its own clock.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch._tree import map_with_path
from repro_torch.configs.base import AttnSpec, LayerSpec, ModelConfig, Segment
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.train import TrainGraph
from repro_torch.models import common as cc
from repro_torch.models.registry import get_api
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import (TrainState, device_batch,
                                             make_train_step)


def program_config(cj: dict) -> ModelConfig:
    """The program's ``ModelConfig`` for a configuration file: one segment
    of ``num_hidden_layers`` attention layers, each with a SwiGLU MLP."""
    attn = AttnSpec(n_heads=cj["num_attention_heads"],
                    n_kv_heads=cj["num_key_value_heads"],
                    head_dim=cj["head_dim"], qk_norm=bool(cj.get("qk_norm")),
                    rope_theta=cj["rope_theta"], window=cj["sliding_window"])
    layer = LayerSpec(kind="attn", mlp="dense", attn=attn,
                      d_ff=cj["intermediate_size"])
    return ModelConfig(
        name=cj["name"], family="dense", d_model=cj["hidden_size"],
        vocab_size=cj["vocab_size"],
        segments=(Segment(count=cj["num_hidden_layers"], layers=(layer,)),),
        norm="rmsnorm", act="silu", tie_embeddings=cj["tie_word_embeddings"],
        dtype=cj["torch_dtype"], remat=cj["remat"], sub_quadratic=False)


def load_kernels(names) -> None:
    """Build (first run in a checkout) or load the named CUDA sources."""
    _build.load_all(tuple(names))


def _path(name: str) -> tuple:
    """A benchmark leaf name -> its path in the program's params tree."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("segments", 0, 0, *parts[1:])
    return tuple(parts)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def params(cfg: ModelConfig, weights: dict, device) -> dict:
    """The program's params tree holding the benchmark's tensors (no copy).
    Every leaf of the program's own tree must be given, in its shape and
    dtype."""
    meta = get_api(cfg).init_params(cfg, seed=0, device="meta")
    given = {_path(k): v for k, v in weights.items()}

    def fill(path, leaf):
        t = given.pop(tuple(path), None)
        if t is None or tuple(t.shape) != tuple(leaf.shape) \
                or t.dtype != leaf.dtype:
            raise ValueError(f"program leaf {path} {tuple(leaf.shape)} "
                             f"{leaf.dtype}: the benchmark gives "
                             f"{None if t is None else (tuple(t.shape), t.dtype)}")
        return t.to(device)

    tree = map_with_path(fill, meta)
    if given:
        raise ValueError(f"leaves the program does not have: {sorted(given)}")
    return tree


@contextlib.contextmanager
def _first_token_clock(box: list):
    """Appends the benchmark's clock to ``box`` when each prefill built in
    the block has returned and the device has finished it."""
    orig = serve_mod.make_prefill

    def make_prefill(cfg, api=None):
        fn = orig(cfg, api)

        def prefill(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out[0].is_cuda:
                torch.cuda.synchronize(out[0].device)
            box.append(time.perf_counter())
            return out
        return prefill

    serve_mod.make_prefill = make_prefill
    try:
        yield
    finally:
        serve_mod.make_prefill = orig


def serve(cfg: ModelConfig, params, prompts: np.ndarray, gen_tokens: int):
    """One ``serve_batch`` call. Returns (served (B, gen) int32 numpy,
    serve_batch's stats, the batch's time to first token in seconds on the
    benchmark's clock, from the call to the end of the prefill)."""
    box: list = []
    with _first_token_clock(box):
        t0 = time.perf_counter()
        served, stats = serve_mod.serve_batch(
            cfg, params, {"tokens": prompts}, gen_tokens, log=lambda *_: None)
    if len(box) != 1:
        raise RuntimeError(f"serve_batch ran {len(box)} prefills; the "
                           "benchmark clocks the first token at the one "
                           "prefill of a batch")
    return served, stats, box[0] - t0


class Trainer:
    """The training step as ``train_loop`` runs it: the donating step,
    replayed by a ``TrainGraph`` on the card (its first call the eager step
    and the capture), eager on the CPU; the state updated in place."""

    def __init__(self, cfg: ModelConfig, opt: dict, params, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.opt_cfg = AdamWConfig(**opt)
        self.state = TrainState(params=params,
                                opt=adamw_init(params, self.opt_cfg.moment_dtype))
        step = make_train_step(cfg, self.opt_cfg, donate=True)
        if self.device.type == "cuda":
            self.knobs = {"use_flash": True, "q_chunk": 0}
            self.graph = TrainGraph(step, self.state)
            self._step = self.graph
        else:
            self.knobs = {}
            self.graph = None
            self._step = lambda batch: step(self.state, batch)[1]
        self._saved = {k: cc.RUNTIME[k] for k in self.knobs}
        cc.RUNTIME.update(self.knobs)

    def step(self, tokens: np.ndarray, labels: np.ndarray) -> dict:
        """One step on a numpy batch; the metrics as device tensors."""
        batch = device_batch(self.cfg, {"tokens": tokens, "labels": labels},
                             self.device)
        return self._step(batch)

    @torch.no_grad()
    def first_grad_norms(self, names) -> dict:
        """After the first step: per leaf and layer, the norm of the
        gradient AdamW received, from its first moment (mu = (1 - b1) g).
        ``names``: (leaf name, layers or 0) pairs."""
        b1 = self.opt_cfg.b1
        return _per_leaf(self.state.opt.mu, names,
                         lambda t, name, i: t.float() / (1 - b1))

    @torch.no_grad()
    def change_norms(self, names, draw) -> dict:
        """Per leaf and layer, ||p - p0|| with p0 = ``draw(name, layer)``."""
        return _per_leaf(self.state.params, names,
                         lambda t, name, i: t.float() - draw(name, i).float())

    def close(self) -> None:
        """Free the graph and restore the runtime knobs."""
        if self.graph is not None:
            self.graph.release()
        cc.RUNTIME.update(self._saved)
        self.state = None
        self.graph = self._step = None


def _per_leaf(tree, names, fn) -> dict:
    """{leaf or leaf[layer]: ||fn(tensor, name, layer)||}."""
    out = {}
    for name, n in names:
        t = _get(tree, _path(name))
        for i in range(n) if n else [None]:
            key = name if i is None else f"{name}[{i}]"
            out[key] = float(torch.linalg.vector_norm(
                fn(t if i is None else t[i], name, i)))
    return out

