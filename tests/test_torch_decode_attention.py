"""The port's decode attention against the reference's Pallas kernel.

On the CPU the port's ``ops.decode_attention`` runs its plain version
(``ref.py``); the reference's ``dec_ops.decode_attention`` runs the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it. Both get the
same numpy inputs. The CUDA kernel itself is checked on the card by
``tests/test_torch_attention_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.flash_attention import ref as jflash_ref
from repro_torch.kernels.decode_attention import kernel as tkernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import ops as tflash

# tests/test_kernels.py::DEC_CASES
DEC_CASES = [
    # (B, T, H, KV, D, n_valid, dtype)
    (1, 256, 4, 4, 64, 200, "float32"),
    (2, 512, 8, 2, 64, 512, "float32"),
    (1, 384, 4, 1, 128, 100, "float32"),     # MQA, non-pow2 T
    (2, 256, 8, 8, 64, 17, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _inputs(b, t, h, kv, d, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, 1, h, d), (b, t, kv, d), (b, t, kv, d))]


def _compare(q, k, v, valid, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdec.decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                 jnp.asarray(valid), block_kv=128)
    got = tdec.decode_attention(*(torch.from_numpy(x).to(tdt)
                                  for x in (q, k, v)), torch.from_numpy(valid))
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,t,h,kv,d,nv,dtype", DEC_CASES)
def test_decode_attention_matches_reference_kernel(b, t, h, kv, d, nv, dtype):
    valid = (np.arange(t) < nv).astype(np.int32)
    _compare(*_inputs(b, t, h, kv, d), valid, dtype)


def _ring_masks(window: int, last_pos: int):
    """Slot masks of a real ring cache of ``window`` slots after positions
    0..last_pos were written (it has wrapped), by the reference's formula
    (``models/attention.py::attn_decode``): for the newest position the
    slots hold positions in rotated order; for a query position behind the
    newest write the slots that hold later positions are holes mid-ring, so
    the mask is not a prefix."""
    slot_pos = np.full((window,), -1, np.int32)
    for p in range(last_pos + 1):
        slot_pos[p % window] = p
    masks = []
    for pos in (last_pos, last_pos - 3, last_pos - window + 2):
        valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - window)
        masks.append(valid.astype(np.int32))
    return masks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_ring_cache_masks_match_reference_kernel(which, dtype):
    window = 40
    valid = _ring_masks(window, last_pos=100)[which]
    if which:
        assert 0 < valid.sum() < window
        first_hole = int(np.argmin(valid))
        assert valid[first_hole:].any(), "the mask should not be a prefix"
    _compare(*_inputs(2, window, 4, 1, 256, seed=5), valid, dtype)


def test_decode_matches_full_last_position():
    """Decode at position S-1 == full attention's last row, in the port and
    against the reference's full attention."""
    b, s, h, kv, d = 1, 128, 4, 2, 64
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tdec.decode_attention(tq[:, -1:], tk, tv,
                                torch.ones(s, dtype=torch.int32))
    full = tflash.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    want = jflash_ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, -1]),
                               rtol=1e-5, atol=1e-5)


def test_ops_route_cpu_tensors_to_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 1, 16))
    before = dict(tkernel.LAUNCHES)
    tdec.decode_attention(q, k, v, torch.ones(16, dtype=torch.bool))
    assert tkernel.LAUNCHES == before


class _OnOtherDevice:
    """Stands in for a tensor on a device the port does not run on (the CPU
    build of torch can make none): the dispatch reads only ``device``. Meta
    tensors go to the plain version, for shape-only pricing."""
    device = torch.device("xpu")


def test_ops_refuse_devices_other_than_cuda_and_cpu():
    q = k = _OnOtherDevice()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdec.decode_attention(q, k, k, torch.ones(8, dtype=torch.int32))
