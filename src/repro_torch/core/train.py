"""Supervised training of the Hulk GNN (paper §4, Fig. 4) + the planning
forward. Port of ``repro/core/train.py``.

Full-batch node classification per graph with masked cross-entropy; Adam with
the paper's hyperparameters (lr 0.01, ~188k params, 10 steps to ~99% node
accuracy on the running example).

* **Inference** — ``predict`` / ``predict_logits`` pad every graph into a
  power-of-two node bucket with an explicit ``node_mask`` and run one cached
  forward per ``(cfg, bucket, d_in)``, the counterpart of the reference's
  per-bucket ``jax.jit``. On the card the cached forward is a CUDA graph of
  ``gnn.apply`` (``BucketGraph``); on the CPU it is the eager forward.
  ``trace_counts()`` counts the cached forwards made per ``(cfg, bucket)``,
  call for call as the reference counts its traces. ``bucketed=False`` (or
  ``FLAGS["bucketed_predict"]``) is the legacy eager path on the unpadded
  graph.
* **Training** — same-bucket ``GraphExample``s are stacked into ``(G, n, ·)``
  tensors. ``joint`` (the default when every graph lands in one bucket)
  takes one Adam step per epoch on the vmapped mean masked loss across
  graphs; ``scan`` takes one Adam step per graph in stack order; ``bucketed``
  does the same bucket by bucket for ragged datasets; ``sequential`` is the
  per-example loop on the unpadded graphs. The steps update the run's own
  params and state in place (the reference donates them); on the card each
  mode's step or epoch is a captured CUDA graph, cached per key as jit
  caches the reference's scans. Metrics stay on the device until the run
  ends.

Label provenance and the feature-version shim:

* ``make_dataset(label_mode=...)`` selects the supervision source:
  ``"analytic"`` (default, the closed-form oracle) or ``"sim"``
  (simulator-refined labels paired with v2 telemetry features; see
  ``core.labels``). Both give the reference's examples bit for bit.
* ``predict`` / ``predict_logits`` derive the node-feature schema from the
  params (``gnn.d_in_of`` -> ``graph.version_for_dim``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import _device, _graph
from repro_torch import obs as obs_mod
from repro_torch._tree import leaves, map_with_path, tree_map
from repro_torch.core import cost_model as cm
from repro_torch.core import gnn
from repro_torch.core import labels as labels_mod
from repro_torch.core.graph import ClusterGraph, random_fleet, version_for_dim
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update_

# Benchmark switch (the reference's benchmarks/plan_bench.py flips it):
# turning ``bucketed_predict`` off restores the legacy eager per-subgraph
# inference path for before/after comparisons.
FLAGS = {"bucketed_predict": True}

BUCKET_MIN = 8


def gnn_config_for(tasks: Sequence[cm.ModelTask], **kw) -> gnn.GNNConfig:
    """n_tasks classes + 1 idle class (paper Table 2 leaves nodes unassigned)."""
    return gnn.GNNConfig(n_classes=len(tasks) + 1, **kw)


@dataclasses.dataclass
class GraphExample:
    feats: np.ndarray
    lat: np.ndarray
    labels: np.ndarray
    mask: np.ndarray


def make_example(graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                 seed: int = 0, label_frac: float = 1.0,
                 label_mode: str = "analytic", jitter=None, traffic=None,
                 comm_model: str = "alphabeta",
                 feature_version: int | None = None) -> GraphExample:
    """One supervised example. Label provenance (``label_mode``):

    * ``"analytic"`` (default) — ``labels.oracle_labels``, the closed-form
      cost-model partition; features default to v1 (the paper's static
      machine description). Bit-identical to the historical behaviour.
    * ``"sim"`` — ``labels.sim_refined_labels``: the analytic partition
      refined by local search on *simulated* makespan under ``jitter`` /
      ``traffic``; features default to v2 with the simulator's observed
      telemetry (slowdowns, jitter sigma, relay hubs) attached, so the GNN
      sees the same signals the labels respond to.
    """
    if label_mode not in ("analytic", "sim"):
        raise ValueError(f"unknown label_mode {label_mode!r}")
    if feature_version is None:
        feature_version = 2 if label_mode == "sim" else 1
    if label_mode == "sim":
        from repro_torch.sim.evaluate import observed_telemetry
        graph = graph.with_telemetry(observed_telemetry(
            graph, jitter=jitter, seed=seed, comm_model=comm_model))
        lab = labels_mod.sim_refined_labels(
            graph, tasks, seed=seed, jitter=jitter, traffic=traffic,
            comm_model=comm_model)
    else:
        lab = labels_mod.oracle_labels(graph, tasks, seed=seed)
    mask = labels_mod.sparse_mask(graph.n, label_frac, seed)
    return GraphExample(graph.node_features(feature_version),
                        graph.latency.astype(np.float32), lab, mask)


def make_dataset(n_graphs: int, tasks: Sequence[cm.ModelTask], n_nodes: int = 24,
                 seed: int = 0, label_frac: float = 0.7,
                 label_mode: str = "analytic", jitter=None, traffic=None,
                 comm_model: str = "alphabeta",
                 feature_version: int | None = None) -> list[GraphExample]:
    """Random-fleet training set. ``label_mode="sim"`` selects sim-refined
    labels + v2 telemetry features (see ``make_example``); the default stays
    the analytic oracle with v1 features."""
    out = []
    for g in range(n_graphs):
        fleet = random_fleet(n_nodes, seed=seed + g)
        out.append(make_example(fleet, tasks, seed=seed + g,
                                label_frac=label_frac, label_mode=label_mode,
                                jitter=jitter, traffic=traffic,
                                comm_model=comm_model,
                                feature_version=feature_version))
    return out


# ---------------------------------------------------------------------------
# Bucketed, cached inference
# ---------------------------------------------------------------------------
def bucket_for(n: int) -> int:
    """Power-of-two node bucket (>= BUCKET_MIN) a graph of n nodes pads into."""
    return max(BUCKET_MIN, 1 << (int(n) - 1).bit_length())


_TRACE_COUNTS: collections.Counter = collections.Counter()
# (cfg, bucket, d_in) -> {params' device, leaf shapes and dtypes: forward}
_FORWARDS: dict = {}


def _keyed_leaves(params) -> list:
    """The leaves of a param tree in the order of their sorted key paths:
    a tree from ``params_from_numpy`` (keys sorted, as jax flattens a dict)
    and one from ``gnn.init`` line up leaf for leaf."""
    out = []
    map_with_path(lambda path, p: out.append((tuple(map(str, path)), p)),
                  params)
    return [p for _, p in sorted(out, key=lambda x: x[0])]


def trace_counts() -> dict:
    """(cfg, bucket) -> number of cached forwards made (traces)."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


def _pad_arrays(feats: np.ndarray, lat: np.ndarray,
                b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A graph's features and latency zero-padded to ``b`` nodes, and its
    node mask."""
    n, d = feats.shape
    pf = np.zeros((b, d), np.float32)
    pf[:n] = feats
    pl = np.zeros((b, b), np.float32)
    pl[:n, :n] = lat
    node_mask = np.zeros((b,), np.float32)
    node_mask[:n] = 1.0
    return pf, pl, node_mask


def _pad_graph(graph: ClusterGraph,
               feature_version: int = 1) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    return _pad_arrays(graph.node_features(feature_version),
                       graph.latency.astype(np.float32), bucket_for(graph.n))


def _shared_pool(dev: torch.device):
    """The memory pool of the device's bucket graphs: that of any captured
    one (a pool lives as long as a graph holds it), or None for a new one."""
    for per_key in _FORWARDS.values():
        for fwd in per_key.values():
            if isinstance(fwd, BucketGraph) and fwd.graph is not None \
                    and fwd.feats.device == dev:
                return fwd.graph.pool()
    return None


class BucketGraph:
    """``gnn.apply`` at one ``(cfg, bucket, d_in)`` captured as a CUDA graph
    and replayed, the counterpart of the reference's jitted forward.

    Its inputs live in static buffers: ``feats (b, d_in)``, ``lat (b, b)``,
    ``node_mask (b,)`` and a copy of the params, because a graph reads its
    tensors by address while the reference's params are arguments. Each
    call copies the caller's params in (one ``_foreach_copy_``), copies the
    graph's features and latency from the host into the static buffers'
    leading rows and columns and zeroes the rest (the padding), replays,
    and returns the static logits. The first call is the warm-up: it runs
    the forward eagerly on the side stream, on the static buffers, and
    returns those logits; then the graph is captured, which runs nothing.
    Every bucket graph of a device is captured into one shared memory pool
    (``_shared_pool``): they replay one at a time on one stream, and what
    outlives a replay (the static buffers and logits) stays referenced
    here, so no later capture reuses it (``_graph.capture``, which also
    counts the replays' launches)."""

    def __init__(self, cfg: gnn.GNNConfig, params, bucket: int, d_in: int):
        dev = _device.of(params)
        self.cfg = cfg
        self.params = tree_map(torch.clone, params)
        self._leaves = _keyed_leaves(self.params)
        self.feats = torch.zeros((bucket, d_in), device=dev)
        self.lat = torch.zeros((bucket, bucket), device=dev)
        self.node_mask = torch.zeros((bucket,), device=dev)
        self.graph = None
        self.logits = None

    def _load(self, params, feats: np.ndarray, lat: np.ndarray) -> None:
        torch._foreach_copy_(self._leaves, _keyed_leaves(params))
        n = feats.shape[0]
        self.feats[:n].copy_(torch.from_numpy(feats))
        self.lat[:n, :n].copy_(torch.from_numpy(lat))
        for pad in (self.feats[n:], self.lat[n:], self.lat[:n, n:],
                    self.node_mask[n:]):
            pad.zero_()
        self.node_mask[:n].fill_(1.0)

    def _forward(self) -> torch.Tensor:
        return gnn.apply(self.params, self.cfg, self.feats, self.lat,
                         node_mask=self.node_mask)

    def __call__(self, params, feats: np.ndarray,
                 lat: np.ndarray) -> torch.Tensor:
        self._load(params, feats, lat)
        if self.graph is not None:
            self.graph.replay()
            return self.logits

        def forward():
            self.logits = self._forward()

        dev = self.feats.device
        self.graph, logits = _graph.capture(   # the warm-up is this answer
            forward, dev, warmup=self._forward, pool=_shared_pool(dev))
        return logits


def _eager_forward(cfg: gnn.GNNConfig, bucket: int):
    """The CPU's cached forward: the padded forward, run eagerly."""
    def fwd(params, feats, lat):
        f, l, m = (torch.from_numpy(a) for a in _pad_arrays(feats, lat, bucket))
        return gnn.apply(params, cfg, f, l, node_mask=m)
    return fwd


def _bucketed_forward(cfg: gnn.GNNConfig, bucket: int, params, d_in: int):
    """The cached forward of ``(cfg, bucket, d_in)`` for params of this
    device, leaf shapes and dtypes, and whether this call made it (a trace,
    counted under ``(cfg, bucket)``). A param tree of other shapes or dtypes
    (bf16, say) gets a forward of its own, as a jax retrace does. The
    forward takes the params and the graph's unpadded features and latency
    (numpy) and returns the bucket's logits."""
    per_key = _FORWARDS.setdefault((cfg, bucket, d_in), {})
    dev = _device.of(params)
    sig = (dev, tuple((tuple(p.shape), p.dtype) for p in _keyed_leaves(params)))
    fwd = per_key.get(sig)
    if fwd is not None:
        return fwd, False
    fwd = (BucketGraph(cfg, params, bucket, d_in) if dev.type == "cuda"
           else _eager_forward(cfg, bucket))
    per_key[sig] = fwd
    _TRACE_COUNTS[(cfg, bucket)] += 1
    return fwd, True


@torch.no_grad()
def predict_logits(params, cfg: gnn.GNNConfig, graph: ClusterGraph, *,
                   bucketed: bool | None = None, device=None) -> np.ndarray:
    """Logits for every node, computed on ``device`` (CUDA by default),
    where ``params`` must lie. ``bucketed`` (default
    ``FLAGS["bucketed_predict"]``): pad into the node bucket and run the
    bucket's cached forward (a CUDA graph on the card); ``False`` is the
    legacy eager forward on the unpadded graph, with no mask, no cache and
    no metrics. The feature-version shim lives here: the feature schema is
    derived from the params (``gnn.d_in_of`` -> ``graph.version_for_dim``),
    so a v1 checkpoint keeps seeing v1 features after the v2 telemetry
    columns were added."""
    dev = _device.resolve(device)
    if _device.of(params) != dev:
        raise ValueError(f"params lie on {_device.of(params)}, not on {dev}")
    version = version_for_dim(gnn.d_in_of(params))
    if bucketed is None:
        bucketed = FLAGS["bucketed_predict"]
    feats = graph.node_features(version)
    lat = graph.latency.astype(np.float32)
    if not bucketed:  # legacy eager path, kept for before/after benchmarks
        t = lambda a: torch.from_numpy(a).to(dev)
        return gnn.apply(params, cfg, t(feats), t(lat)).cpu().numpy()
    b = bucket_for(graph.n)
    fwd, traced = _bucketed_forward(cfg, b, params, feats.shape[1])
    logits = fwd(params, feats, lat)
    rec = obs_mod.current()
    if rec.enabled:
        rec.metrics.inc(f"plan.jit.bucket{b}.calls")
        rec.metrics.inc(f"plan.jit.bucket{b}."
                        + ("compiles" if traced else "cache_hits"))
    return logits[:graph.n].cpu().numpy()


def predict(params, cfg: gnn.GNNConfig, graph: ClusterGraph, *,
            bucketed: bool | None = None, device=None) -> np.ndarray:
    return np.argmax(predict_logits(params, cfg, graph, bucketed=bucketed,
                                    device=device), axis=-1)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
_STACK_KEYS = ("feats", "lat", "labels", "label_mask", "node_mask")
_EXAMPLE_KEYS = ("feats", "lat", "labels", "label_mask")
# (cfg, opt_cfg, mode, input shapes, device) -> _Trainer, the counterpart of
# jit's cache on the static cfg / opt_cfg and the array shapes
_TRAINERS: dict = {}


def _stack_buckets(dataset: Sequence[GraphExample]) -> dict[int, dict]:
    """Group examples by node bucket (order-preserving within a bucket) and
    pad/stack each group into (G, b, ·) arrays. ``label_mask`` is 0 on padded
    rows, so per-graph losses/grads equal their unpadded values exactly."""
    groups: dict[int, list[GraphExample]] = {}
    for ex in dataset:
        groups.setdefault(bucket_for(ex.feats.shape[0]), []).append(ex)
    stacks = {}
    for b, exs in groups.items():
        g, d = len(exs), exs[0].feats.shape[1]
        feats = np.zeros((g, b, d), np.float32)
        lat = np.zeros((g, b, b), np.float32)
        labels = np.zeros((g, b), np.int64)
        lmask = np.zeros((g, b), np.float32)
        nmask = np.zeros((g, b), np.float32)
        for i, ex in enumerate(exs):
            n = ex.feats.shape[0]
            feats[i, :n] = ex.feats
            lat[i, :n, :n] = ex.lat
            labels[i, :n] = ex.labels
            lmask[i, :n] = ex.mask
            nmask[i, :n] = 1.0
        stacks[b] = {"feats": feats, "lat": lat, "labels": labels,
                     "label_mask": lmask, "node_mask": nmask}
    return stacks


def _grads(loss: torch.Tensor, live):
    """d loss / d every leaf of ``live``, as a tree of the same shape."""
    gs = iter(torch.autograd.grad(loss, leaves(live)))
    return tree_map(lambda _: next(gs), live)


def _graph_step_(live, params, opt_state, cfg, opt_cfg, ex: dict,
                 out: torch.Tensor) -> None:
    """One Adam step on one graph, in place (the reference's ``_train_step``
    and ``_graph_scan_body``): ``adamw_update_`` writes the new params and
    state into ``params`` and ``opt_state``, and the graph's loss and
    accuracy go to ``out`` (2,). ``live`` are the params' leaves as autograd
    leaves sharing their storage."""
    loss, m = gnn.loss_fn(live, cfg, ex["feats"], ex["lat"], ex["labels"],
                          ex["label_mask"], node_mask=ex.get("node_mask"))
    adamw_update_(opt_cfg, _grads(loss, live), opt_state, params)
    out[0].copy_(loss.detach())
    out[1].copy_(m["accuracy"])


def _epoch_(live, params, opt_state, cfg, opt_cfg, stack: dict,
            out: torch.Tensor) -> None:
    """One Adam step per graph of the stack, in stack order (the
    reference's inner ``lax.scan``); ``out`` (2, G) takes each graph's loss
    and accuracy."""
    for g in range(stack["feats"].shape[0]):
        _graph_step_(live, params, opt_state, cfg, opt_cfg,
                     {k: v[g] for k, v in stack.items()}, out[:, g])


def _joint_loss(params, cfg, stack: dict):
    """The masked loss and accuracy of every graph of the stack, (G,) each:
    ``gnn.loss_fn`` vmapped over the stack, the reference's ``_joint_loss``.
    One batched forward (and backward) instead of G."""
    def one(feats, lat, labels, label_mask, node_mask):
        loss, m = gnn.loss_fn(params, cfg, feats, lat, labels, label_mask,
                              node_mask=node_mask)
        return loss, m["accuracy"]
    return torch.func.vmap(one)(*(stack[k] for k in _STACK_KEYS))


def _joint_step_(live, params, opt_state, cfg, opt_cfg, stack: dict,
                 out: torch.Tensor) -> None:
    """One Adam step on the mean masked loss of the stack, in place;
    ``out`` (2, G) takes each graph's loss and accuracy."""
    losses, accs = _joint_loss(live, cfg, stack)
    adamw_update_(opt_cfg, _grads(losses.mean(), live), opt_state, params)
    out[0].copy_(losses.detach())
    out[1].copy_(accs)


class _Program:
    """One training program (a step or an epoch) that steps a trainer's
    static tensors in place: ``fn()``. Without ``capture`` (the CPU) every
    call runs it eagerly. With it, the first call runs ``fn`` eagerly on the
    side stream, as that call's own work and the warm-up autograd needs,
    then captures it into ``pool``, which runs nothing; every later call
    replays the graph. A capture that fails raises."""

    def __init__(self, fn, capture: bool):
        self.fn = fn
        self.capture = capture
        self.graph = None

    def __call__(self, dev: torch.device, pool) -> None:
        if not self.capture:
            self.fn()
            return
        if self.graph is not None:
            self.graph.replay()
            return
        self.graph, _ = _graph.capture(self.fn, dev, pool=pool)


def _resolve_mode(dataset: Sequence[GraphExample], mode: str):
    """The mode "auto" resolves to, and the numpy stacks of the stacked
    modes (None for "sequential")."""
    if mode == "sequential":
        return mode, None
    stacks = list(_stack_buckets(dataset).values())
    if mode == "auto":
        # one Adam step per epoch on the mean masked loss; ragged datasets
        # fall back to per-bucket stacking
        mode = "joint" if len(stacks) == 1 else "bucketed"
    if mode in ("joint", "scan") and len(stacks) != 1:
        raise ValueError(f"{mode} mode needs all graphs in one node bucket;"
                         " use mode='bucketed' for ragged datasets")
    if mode not in ("joint", "scan", "bucketed"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode, stacks


class _Trainer:
    """The static tensors of the ``train_gnn`` runs of one key and the
    programs that step them, the counterpart of the reference's jitted,
    donating scans: the params, ``live`` (their leaves as autograd leaves,
    sharing their storage, made once), the AdamW state, the device stacks
    (in the sequential mode one example buffer per node count instead) and
    ``out``, the (2, G) losses and accuracies of the last step or epoch.

    Programs: "joint" one step on the stack (``_joint_step_``), "scan" one
    epoch over it (``_epoch_``), "bucketed" one epoch per bucket stack,
    "sequential" one step per node count (``_graph_step_`` on the unpadded
    example). With ``capture`` each is a CUDA graph, all of them in one
    memory pool; ``load`` puts the next run's params, a fresh state and
    its stacks into the static tensors, so that the graphs replay it."""

    def __init__(self, cfg, opt_cfg, mode: str, params, dataset, stacks,
                 dev: torch.device, capture: bool):
        self.mode, self.dev = mode, dev
        self.params = tree_map(lambda p: p.detach().to(dev, copy=True),
                               params)
        self.live = tree_map(lambda p: p.detach().requires_grad_(True),
                             self.params)
        self.opt_state = adamw_init(self.params)
        self.pool = None
        # copies: the static tensors are written by later calls, and on the
        # CPU a plain .to() would share the caller's numpy memory
        t = lambda a: torch.from_numpy(a).to(dev, copy=True)
        state = (self.live, self.params, self.opt_state, cfg, opt_cfg)
        if mode == "sequential":
            self.stacks = []
            self.examples = {}
            for ex in dataset:   # each step copies its example in
                self.examples.setdefault(ex.feats.shape[0], {
                    k: t(a) for k, a in zip(
                        _EXAMPLE_KEYS, (ex.feats, ex.lat, ex.labels, ex.mask))})
            self.out = torch.zeros(2, device=dev)
            self.programs = {
                n: _Program(lambda ex=ex: _graph_step_(*state, ex, self.out),
                            capture) for n, ex in self.examples.items()}
            return
        self.stacks = [{k: t(s[k]) for k in _STACK_KEYS} for s in stacks]
        self.out = torch.zeros(
            (2, sum(s["feats"].shape[0] for s in stacks)), device=dev)
        body = _joint_step_ if mode == "joint" else _epoch_
        self.programs, col = [], 0
        for s in self.stacks:
            g = s["feats"].shape[0]
            out = self.out[:, col:col + g]
            self.programs.append(_Program(
                lambda s=s, out=out: body(*state, s, out), capture))
            col += g

    def load(self, params, stacks) -> None:
        """The next run's params, a fresh AdamW state and (stacked modes)
        stacks into the static tensors, with one ``_foreach_copy_``."""
        params = tree_map(lambda p: p.detach().to(self.dev), params)
        fresh = adamw_init(params)
        st = self.opt_state
        dst = (_keyed_leaves(self.params) + _keyed_leaves(st.mu)
               + _keyed_leaves(st.nu) + [st.step]
               + [s[k] for s in self.stacks for k in _STACK_KEYS])
        src = (_keyed_leaves(params) + _keyed_leaves(fresh.mu)
               + _keyed_leaves(fresh.nu) + [fresh.step]
               + [torch.from_numpy(s[k]).to(self.dev)
                  for s in stacks or () for k in _STACK_KEYS])
        torch._foreach_copy_(dst, src)

    def _call(self, program: _Program) -> None:
        program(self.dev, self.pool)
        if self.pool is None and program.graph is not None:
            self.pool = program.graph.pool()

    def run(self, steps: int, dataset) -> list[dict]:
        """``steps`` epochs; the history as the reference reports it."""
        if self.mode == "sequential":
            # a host sync per step, as the reference's float(m["loss"])
            history = []
            for step in range(steps):
                losses, accs = [], []
                for ex in dataset:
                    buf = self.examples[ex.feats.shape[0]]
                    for k, a in zip(_EXAMPLE_KEYS,
                                    (ex.feats, ex.lat, ex.labels, ex.mask)):
                        buf[k].copy_(torch.from_numpy(a))
                    self._call(self.programs[ex.feats.shape[0]])
                    loss, acc = self.out.tolist()
                    losses.append(loss)
                    accs.append(acc)
                history.append({"step": step, "loss": float(np.mean(losses)),
                                "accuracy": float(np.mean(accs))})
            return history
        # (steps, 2, G) on the device, read once at the end
        hist = torch.empty((steps,) + tuple(self.out.shape), device=self.dev)
        for step in range(steps):
            for program in self.programs:
                self._call(program)
            hist[step].copy_(self.out)
        return _history_from(hist[:, 0], hist[:, 1])


def _history_from(loss: torch.Tensor, acc: torch.Tensor) -> list[dict]:
    loss = loss.cpu().numpy()    # (steps, G)
    acc = acc.cpu().numpy()
    return [{"step": s, "loss": float(loss[s].mean()),
             "accuracy": float(acc[s].mean())} for s in range(loss.shape[0])]


def _opt_config(lr: float) -> AdamWConfig:
    return AdamWConfig(learning_rate=lr, weight_decay=0.0, b2=0.999,
                       grad_clip_norm=0.0)


def _key(cfg, opt_cfg, mode: str, dataset, stacks, dev) -> tuple:
    shapes = (tuple(ex.feats.shape for ex in dataset) if stacks is None
              else tuple(s["feats"].shape for s in stacks))
    return cfg, opt_cfg, mode, shapes, dev


def train_gnn(cfg: gnn.GNNConfig, dataset: Sequence[GraphExample],
              steps: int = 10, lr: float = 0.01, seed: int = 0,
              params=None, mode: str = "auto", device=None):
    """Train for ``steps`` epochs over the dataset on ``device`` (CUDA by
    default); returns (params, history). ``params`` (a tensor tree, e.g. from
    ``gnn.params_from_numpy``) is copied, never modified; without it the
    params come from ``gnn.init(cfg, d_in, seed)``.

    With a single graph in the dataset this reproduces the paper's Fig. 4
    setting (10 steps, lr 0.01).

    ``mode``: "joint" (the default via "auto" when every graph lands in one
    node bucket) takes one Adam step per epoch on the vmapped mean masked
    loss across graphs, so it sees one update per epoch where the per-graph
    modes see one per graph. "scan" takes per-graph Adam steps over the
    stacked, padded graphs — the trajectory of "sequential" (the
    per-example loop on unpadded graphs, with a host sync per step) within
    float tolerance. Ragged datasets fall back to per-bucket stacks
    ("bucketed", processed bucket by bucket each epoch).

    The steps update the run's own copy of the params and state in place
    (the reference donates them). On the card each program of the mode (the
    joint step, an epoch, a bucket's epoch, a sequential step per node
    count) is a CUDA graph: its first call runs eagerly and captures it, and
    the rest replay. The graphs and their static tensors are cached per
    ``(cfg, opt_cfg, mode, input shapes, device)``, as jit caches its
    programs: a later call with the same key copies its params, a fresh
    state and its stacks in and replays without capturing. Losses and
    accuracies stay on the device until the run ends (the sequential mode
    reads each step's). On the CPU the same steps run eagerly."""
    dev = _device.resolve(device)
    mode, stacks = _resolve_mode(dataset, mode)
    if params is None:
        params = gnn.init(cfg, dataset[0].feats.shape[1], seed=seed,
                          device=dev)
    opt_cfg = _opt_config(lr)
    key = _key(cfg, opt_cfg, mode, dataset, stacks, dev)
    trainer = _TRAINERS.get(key)
    if trainer is None:
        trainer = _TRAINERS[key] = _Trainer(cfg, opt_cfg, mode, params,
                                            dataset, stacks, dev,
                                            capture=dev.type == "cuda")
    else:
        trainer.load(params, stacks)
    history = trainer.run(steps, dataset)
    # the static params belong to the cached graphs: hand out a copy
    return tree_map(lambda p: p.detach().clone(), trainer.params), history
