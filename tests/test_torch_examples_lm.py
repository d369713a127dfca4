"""The LM twins (``repro_torch.examples.serve_batch`` and ``train_e2e``)
on the CPU.

* ``serve_batch``: the reference example and the twin serve reduced
  gemma3-1b (fp32) from the same weights (the reference's
  ``jax.random.PRNGKey(0)`` init, carried over by
  ``decoder_lm.params_from_numpy``); the twin must print the reference's
  tokens for every request. The two lines that print this run's prefill
  and decode times and rates are left out.
* ``train_e2e``: the reference example cannot run here (its ``train_loop``
  raises ``ShardingTypeError`` on the embedding gather on jax 0.9.0, the
  known failure of ``tests/test_train_resume.py``). The twin is held
  instead to the example's own ``last < first`` (it raises otherwise), to
  its restart (phase 2 resumes from phase 1's last checkpoint and logs
  from there), and to the resume contract of ``test_train_resume.py`` at
  the example's shapes (reduced xlstm-125m, batch 8 x 128 tokens): N steps
  straight give the losses of k steps, a fresh loop and a resume, at that
  test's rtol 1e-5 / atol 1e-6. The step itself is held to the reference's
  jitted step by ``tests/test_torch_train_step.py``."""
import dataclasses

import jax
import numpy as np
import torch

torch.set_num_threads(1)

from _torch_examples import assert_same_output, output_of, reference_example
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models.registry import get_api as jget_api
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.examples import serve_batch, train_e2e
from repro_torch.launch.train import train_loop
from repro_torch.models import decoder_lm as tdlm

SERVE_WALL_CLOCK = ("decode tok/s", "toks x4: ")


def test_serve_batch_twin_prints_the_reference_tokens(monkeypatch):
    ref = reference_example("serve_batch")
    want = output_of(ref.main)
    jcfg = dataclasses.replace(jreduce(jget_config("gemma3-1b")), remat=False)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tdlm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    real = serve_batch.get_api
    monkeypatch.setattr(serve_batch, "get_api", lambda cfg: dataclasses.replace(
        real(cfg), init_params=lambda cfg, seed, device: tparams))
    got = output_of(serve_batch.main, ["--device", "cpu"])
    assert_same_output(want, got, wall_clock=SERVE_WALL_CLOCK)
    assert sum(l.startswith("  request ") for l in got) == 4


def test_train_e2e_twin_resumes_and_makes_progress(tmp_path, monkeypatch):
    runs = []
    real = train_e2e.train_loop

    def watched(cfg, steps, **kw):
        state, hist = real(cfg, steps, **kw)
        runs.append((steps, kw, hist))
        return state, hist

    monkeypatch.setattr(train_e2e, "train_loop", watched)
    ckpt = tmp_path / "ckpt"
    lines = output_of(train_e2e.main, ["--steps", "10", "--device", "cpu",
                                       "--ckpt-dir", str(ckpt)])
    (s1, kw1, h1), (s2, kw2, h2) = runs
    assert (s1, s2) == (6, 10) and kw1 == kw2
    assert kw1["ckpt_dir"] == str(ckpt)
    assert kw1["device"] == torch.device("cpu")
    assert [h["step"] for h in h1] == [0, 5]
    assert [h["step"] for h in h2] == [9]
    assert "resumed from step 6" in lines
    assert "-- simulated restart: resuming from latest checkpoint --" in lines
    first, last = h1[0]["loss"], h2[-1]["loss"]
    assert last < first
    assert lines[-1] == (f"loss {first:.4f} -> {last:.4f} across a restart "
                         "(improved)")


def test_train_e2e_shapes_resume_matches_uninterrupted(tmp_path):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("xlstm-125m")),
                              remat=False)
    kw = dict(global_batch=8, seq_len=128, lr=1e-3, log_every=1,
              ckpt_every=3, keep_k=2, log=lambda *a: None,
              schedule_steps=8, device="cpu")
    _, straight = train_loop(cfg, 8, ckpt_dir=str(tmp_path / "a"), **kw)
    train_loop(cfg, 4, ckpt_dir=str(tmp_path / "b"), **kw)
    _, resumed = train_loop(cfg, 8, ckpt_dir=str(tmp_path / "b"), **kw)
    by_step = {h["step"]: h["loss"] for h in straight}
    assert [h["step"] for h in resumed] == list(range(4, 8))
    for h in resumed:
        np.testing.assert_allclose(h["loss"], by_step[h["step"]],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"divergence at step {h['step']}")
