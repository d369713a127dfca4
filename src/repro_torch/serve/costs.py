"""Per-token serving cost model for simulated replicas.

A ``ServeModel`` is everything a replica needs to turn a request into
simulated seconds and bytes: per-token prefill/decode FLOPs, per-token KV
bytes, resident weight bytes, wire bytes, and phase efficiencies (prefill is
compute-bound and runs near peak; decode is memory-bandwidth-bound and
realizes a small fraction of peak FLOP/s — the efficiency divisors model
that without a per-GPU bandwidth table).

Three ways to build one, in increasing fidelity:

* ``serve_model_from_task`` — analytic: a forward pass costs ~2 x params
  FLOPs/token; the KV cache carries 2 x layers x d_model x dtype bytes per
  token (standard MHA bookkeeping).
* ``serve_model_from_hlo`` — from ``analysis.hlo_cost.analyze`` results of a
  compiled prefill and decode step: the per-token FLOPs are whatever XLA
  actually lowered, so architecture quirks (MoE routing, sliding windows,
  MLA) are priced for free. This is the path the calibration test locks:
  the zero-contention simulated replica throughput must reproduce the
  analytic throughput derived from these numbers within 1%.
* ``serve_model_from_config`` — convenience wrapper: lower
  ``training.train_step.make_prefill`` / ``make_decode_step`` for a model
  config, run the HLO analyzer, and measure KV bytes from the real decode
  cache pytree via ``jax.eval_shape`` (no allocation).

Port of ``repro/serve/costs.py``. ``serve_model_from_config`` runs the
port's programs on the meta device through ``analysis.program_cost``, the
counterpart of the reference's HLO analyzer.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model as cm

# Phase efficiency defaults: fraction of peak FLOP/s a phase realizes.
# Prefill is a large batched matmul (near-roofline); decode at small batch is
# weight-streaming-bound, ~5% of peak on typical HBM/FLOP ratios.
PREFILL_EFFICIENCY = 0.5
DECODE_EFFICIENCY = 0.05


@dataclasses.dataclass(frozen=True)
class ServeModel:
    """Inference-time cost card for one served model."""
    name: str
    prefill_flops_per_token: float
    decode_flops_per_token: float
    kv_bytes_per_token: float
    weight_bytes: float
    prefill_efficiency: float = PREFILL_EFFICIENCY
    decode_efficiency: float = DECODE_EFFICIENCY
    request_bytes_per_token: float = 4.0    # prompt tokens over the wire
    response_bytes_per_token: float = 4.0   # generated tokens back

    # -- effective work (efficiency-adjusted FLOPs the compute model runs) --
    def prefill_work(self, tokens: float) -> float:
        return tokens * self.prefill_flops_per_token / self.prefill_efficiency

    def decode_work(self, tokens: float) -> float:
        return tokens * self.decode_flops_per_token / self.decode_efficiency

    def service_work(self, prompt_tokens: float, gen_tokens: float) -> float:
        """Total effective FLOPs to serve one request (queueing aside)."""
        return self.prefill_work(prompt_tokens) + self.decode_work(gen_tokens)

    def service_s(self, prompt_tokens: float, gen_tokens: float,
                  tflops: float) -> float:
        """Analytic zero-contention service time on a ``tflops`` machine —
        the calibration contract the simulated replica must reproduce."""
        return self.service_work(prompt_tokens, gen_tokens) / (tflops * 1e12)

    def decode_tokens_per_s(self, tflops: float) -> float:
        """Analytic steady-state decode throughput of one replica."""
        return tflops * 1e12 / (self.decode_flops_per_token
                                / self.decode_efficiency)

    def kv_capacity_tokens(self, memory_gb: float,
                           headroom: float = 0.9) -> int:
        """Resident KV tokens a machine can hold next to the weights."""
        free = memory_gb * 1e9 * headroom - self.weight_bytes
        if free <= 0:
            return 0
        return int(free / self.kv_bytes_per_token)


def serve_model_from_task(task: cm.ModelTask, name: str | None = None,
                          **kw) -> ServeModel:
    """Analytic cost card from a training ``ModelTask`` description."""
    return ServeModel(
        name=name or task.name,
        prefill_flops_per_token=2.0 * task.params,
        decode_flops_per_token=2.0 * task.params,
        kv_bytes_per_token=2.0 * task.n_layers * task.d_model
        * task.dtype_bytes,
        weight_bytes=task.param_bytes,
        **kw)


def serve_model_from_hlo(name: str, prefill_analysis: dict,
                         decode_analysis: dict, *, prefill_tokens: int,
                         decode_batch: int, kv_bytes_per_token: float,
                         weight_bytes: float, **kw) -> ServeModel:
    """Cost card from ``analysis.hlo_cost.analyze`` dicts of a compiled
    prefill (``prefill_tokens`` total prompt tokens in the batch) and a
    single decode step (``decode_batch`` sequences, one token each)."""
    return ServeModel(
        name=name,
        prefill_flops_per_token=prefill_analysis["flops"]
        / max(prefill_tokens, 1),
        decode_flops_per_token=decode_analysis["flops"]
        / max(decode_batch, 1),
        kv_bytes_per_token=kv_bytes_per_token,
        weight_bytes=weight_bytes,
        **kw)


def serve_model_from_config(cfg, *, batch: int = 2, prompt_len: int = 16,
                            gen_tokens: int = 8, seed: int = 0,
                            name: str | None = None, **kw) -> ServeModel:
    """Run the real prefill/decode programs for ``cfg`` on the meta device,
    price them with ``analysis.program_cost`` (the port's counterpart of the
    reference's loop-aware HLO analyzer), and measure weight/KV bytes from
    the real parameter and cache trees (shape-only; nothing is allocated or
    drawn, so a full-width model prices on the host)."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.analysis import program_cost
    from repro_torch.data.synthetic import SyntheticConfig, make_batch
    from repro_torch.models.common import DTYPES
    from repro_torch.models.registry import get_api
    from repro_torch.training.train_step import make_decode_step, make_prefill

    api = get_api(cfg)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    max_len = extra + prompt_len + gen_tokens
    batch_np = make_batch(cfg, SyntheticConfig(global_batch=batch,
                                               seq_len=prompt_len,
                                               seed=seed), 0)
    # tokens as make_batch gives them, frames / patches in the activation
    # dtype (train_step.device_batch)
    inputs = {k: torch.empty(v.shape, device="meta", dtype=(
                  DTYPES[cfg.dtype] if k in ("frames", "patches")
                  else torch.from_numpy(v[:0]).dtype))
              for k, v in batch_np.items() if k != "labels"}
    params = api.init_params(cfg, seed=seed, device="meta")

    def nbytes(tree) -> float:
        return float(sum(t.numel() * t.element_size() for t in leaves(tree)))

    prefill, (_, caches) = program_cost.measure(make_prefill(cfg, api),
                                                params, inputs, max_len)
    kv_bytes = nbytes(caches) / (batch * max_len)

    token = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    decode = program_cost.analyze(make_decode_step(cfg, api), params, token,
                                  pos, caches)

    return serve_model_from_hlo(
        name or getattr(cfg, "name", "model"), prefill, decode,
        prefill_tokens=batch * prompt_len, decode_batch=batch,
        kv_bytes_per_token=kv_bytes, weight_bytes=nbytes(params), **kw)


def serve_task_for(model: ServeModel, n_replicas: int,
                   kv_reserve_tokens: int = 4096) -> cm.ModelTask:
    """A pseudo training task whose Algorithm 1 memory threshold sizes a
    machine group able to host ``n_replicas`` full replicas (weights + a KV
    reservation each) — the bridge that lets ``core.assign`` place serving
    replicas with the same GNN machinery it uses for training groups."""
    per_replica = model.weight_bytes \
        + kv_reserve_tokens * model.kv_bytes_per_token
    # ModelTask.min_memory_gb = params * 16 / 1e9  =>  invert it
    params = n_replicas * per_replica / 16.0
    return cm.ModelTask(name=f"serve:{model.name}", params=params,
                        n_layers=32, d_model=4096)
