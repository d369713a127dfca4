"""The port's launch ledger (``repro_torch._graph``) on the CPU: the four
kernel modules' ``LAUNCHES`` are the ledger's own dicts, no wrapper name is
registered twice, and ``reset`` zeroes every registered count. Imports no
JAX:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graph.py

``count`` asks the current CUDA stream whether it captures, which a
CPU-only PyTorch cannot answer; the card tests cover it
(``tests/test_torch_graphs_gpu.py``)."""
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.gcn_spmm import kernel as spmm_kernel

# kernel module -> the wrapper names it owns
OWNED = {flash_kernel: ("flash_attention", "flash_attention.wgmma",
                        "flash_attention_bwd"),
         dec_kernel: ("decode_attention",),
         spmm_kernel: ("scaled_spmm", "spmm"),
         adamw_kernel: ("global_norm", "adamw_update")}


@pytest.mark.parametrize("module", list(OWNED),
                         ids=lambda m: m.__name__.split(".")[-2])
def test_launches_are_the_ledgers_own_dict(module):
    assert tuple(module.LAUNCHES) == OWNED[module]
    for name in module.LAUNCHES:
        assert _graph.COUNTERS[name] is module.LAUNCHES
        assert name in _graph.CAPTURED


def test_no_name_is_registered_twice():
    names = [n for module in OWNED for n in module.LAUNCHES]
    assert len(names) == len(set(names))
    assert set(names) == set(_graph.COUNTERS) == set(_graph.CAPTURED)
    before = dict(_graph.COUNTERS)
    with pytest.raises(ValueError, match="registered twice"):
        _graph.register("decode_attention")
    assert _graph.COUNTERS == before
    assert _graph.COUNTERS["decode_attention"] is dec_kernel.LAUNCHES


def test_reset_zeroes_every_registered_count():
    captured = dict(_graph.CAPTURED)
    for i, name in enumerate(_graph.COUNTERS, 1):
        _graph.COUNTERS[name][name] = i
    _graph.reset()
    for module in OWNED:
        assert module.LAUNCHES == dict.fromkeys(OWNED[module], 0)
    assert _graph.CAPTURED == captured   # the captures' running counts stay
