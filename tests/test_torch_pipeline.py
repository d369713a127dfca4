"""The port's GPipe pipeline on 4 gloo ranks against the reference's
``gpipe_forward`` / ``jax.grad`` on 4 forced host devices, on the same numpy
params, at tests/test_pipeline.py's tolerances (forward rtol 1e-5, grads
rtol 1e-4, atol 1e-5). Both sides run in subprocesses: the reference needs
its forced device count before jax starts, the port one process per rank.
"""
import os
import socket
import subprocess
import sys

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
S, M, MB, D = 4, 8, 2, 16

# The reference: tests/test_pipeline.py's setup, saved with its results.
_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[2])
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.parallel import pipeline as pp

S, M, MB, D = 4, 8, 2, 16
mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))

def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])

ks = jax.random.split(jax.random.PRNGKey(0), S)
per_stage = [{"w": jax.random.normal(k, (D, D)) * 0.3,
              "b": jax.random.normal(jax.random.fold_in(k, 1), (D,)) * 0.1}
             for k in ks]
stacked = pp.stack_stage_params(per_stage)
x = jax.random.normal(jax.random.PRNGKey(1), (M * MB, D))
xm = pp.microbatch(x, M)
tgt = jax.random.normal(jax.random.PRNGKey(2), (M, MB, D))
y = pp.gpipe_forward(stage_fn, mesh, "stage", M)(stacked, xm)
loss = pp.gpipe_loss(stage_fn, lambda y, t: jnp.mean((y - t) ** 2), mesh,
                     "stage", M)
g = jax.grad(loss)(stacked, xm, tgt)
np.savez(sys.argv[1], w=stacked["w"], b=stacked["b"], x=x, tgt=tgt, y=y,
         gw=g["w"], gb=g["b"])
print("REFERENCE_OK")
"""

# The port: one process per stage rank.
_RANK = r"""
import sys
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import mesh as lm
from repro_torch.parallel import pipeline as pp

rank, port, ref = int(sys.argv[1]), int(sys.argv[2]), np.load(sys.argv[3])
M = 8
lm.init_process_group("gloo", world_size=4, rank=rank, port=port)
mesh = lm.device_mesh((4,), ("stage",), device="cpu")

def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])

per_stage = [{"w": torch.from_numpy(ref["w"][s]), "b": torch.from_numpy(ref["b"][s])}
             for s in range(4)]
stacked = {k: v.requires_grad_(True)
           for k, v in pp.stack_stage_params(per_stage).items()}
xm = pp.microbatch(torch.from_numpy(ref["x"]), M)
y = pp.gpipe_forward(stage_fn, mesh, "stage", M)(stacked, xm)
np.testing.assert_allclose(y.detach().numpy(), ref["y"], rtol=1e-5, atol=1e-5)
# and the serial forward, as the reference's test checks its own
y_ser = torch.from_numpy(ref["x"])
for p in per_stage:
    y_ser = stage_fn(p, y_ser)
np.testing.assert_allclose(y.detach().numpy().reshape(y_ser.shape),
                           y_ser.numpy(), rtol=1e-5, atol=1e-5)

loss = pp.gpipe_loss(stage_fn, lambda y, t: ((y - t) ** 2).mean(), mesh,
                     "stage", M)(stacked, xm, torch.from_numpy(ref["tgt"]))
loss.backward()
# each rank holds its own stage's gradient; the sum over ranks is the whole
gw, gb = stacked["w"].grad.clone(), stacked["b"].grad.clone()
assert float(gw[[s for s in range(4) if s != rank]].abs().max()) == 0.0
torch.distributed.all_reduce(gw)
torch.distributed.all_reduce(gb)
np.testing.assert_allclose(gw.numpy(), ref["gw"], rtol=1e-4, atol=1e-5)
np.testing.assert_allclose(gb.numpy(), ref["gb"], rtol=1e-4, atol=1e-5)

# params as DTensors sharded over the stage axis (stage_sharding)
from torch.distributed.tensor import distribute_tensor
placed = {k: distribute_tensor(v.detach(), mesh, pl) for (k, v), pl in zip(
    stacked.items(), pp.stage_sharding(mesh, "stage", stacked).values())}
y2 = pp.gpipe_forward(stage_fn, mesh, "stage", M)(placed, xm)
assert torch.equal(y2, y)
print("PIPELINE_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gpipe_on_4_gloo_ranks_matches_the_reference(tmp_path):
    ref = str(tmp_path / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE, ref, SRC],
                         capture_output=True, text=True, env=env, timeout=300)
    assert "REFERENCE_OK" in res.stdout, res.stdout + res.stderr
    saved = np.load(ref)
    assert saved["y"].shape == (M, MB, D) and saved["gw"].shape == (S, D, D)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, ref,
                               SRC], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(S)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "PIPELINE_OK" in out, out + err


def test_microbatch_and_stacking():
    import torch
    from repro_torch.parallel import pipeline as pp
    x = torch.arange(24.0).reshape(12, 2)
    assert torch.equal(pp.microbatch(x, 3).reshape(12, 2), x)
    assert pp.microbatch(x, 3).shape == (3, 4, 2)
    stacked = pp.stack_stage_params([{"w": torch.ones(2)}, {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)
    import pytest
    with pytest.raises(ValueError, match="microbatches"):
        pp.microbatch(x, 5)
