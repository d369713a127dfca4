"""The yardstick's arithmetic on hand-computed cases at phi3-mini's shapes,
with its 2047-token window and without one: the kernels' operations and
bytes, the step counts behind the two ``mfu`` metrics, and each
device-trace reader on a made-up trace."""
import json
import types
from pathlib import Path

import pytest

from bench import counts, harness
from bench.trace import Activity, Trace

BENCH = Path(__file__).resolve().parents[1]
PHI3 = json.loads((BENCH / "configs" / "phi3-mini-3.8b.json").read_text())
FULL = dict(PHI3, sliding_window=None)          # attention over every position


def test_visible_pairs():
    assert counts.visible_pairs(1) == 1
    assert counts.visible_pairs(4) == 10
    assert counts.visible_pairs(4096) == 8_390_656
    # window 2: positions 0..3 see 1, 2, 2, 2 keys
    assert counts.visible_pairs(4, 2) == 7
    assert counts.visible_pairs(4, 4) == counts.visible_pairs(4, 9) == 10
    # 2047 * 2048 / 2 over the first 2047 positions, then 2047 each
    assert counts.visible_pairs(3968, 2047) == 2_096_128 + 1921 * 2047 == 6_028_415
    assert counts.visible_pairs(4096, 2047) == 2_096_128 + 2049 * 2047 == 6_290_431
    assert [counts.visible(p, 3) for p in range(5)] == [1, 2, 3, 3, 3]
    assert counts.visible(4000) == 4001
    assert counts.cache_slots(PHI3, 4096) == 2047
    assert counts.cache_slots(PHI3, 100) == 100
    assert counts.cache_slots(FULL, 4096) == 4096


def test_flash_forward_phi3_prefill():
    # B 16, S 3968, 32 heads of 96, 6,028,415 visible pairs in the window;
    # 4 * 96 * pairs * 16 * 32 operations; q, o, k, v of 16 * 3968 * 3072
    # bf16 values each, whatever the window
    flops, nbytes = counts.flash_fwd(16, 3968, 32, 32, 96, window=2047)
    assert flops == 4 * 96 * 6_028_415 * 16 * 32 == 1_185_234_616_320
    assert nbytes == 4 * 16 * 3968 * 3072 * 2 == 1_560_281_088
    # without a window: 3968 * 3969 / 2 = 7,874,496 pairs
    assert counts.flash_fwd(16, 3968, 32, 32, 96)[0] == 1_548_188_909_568


def test_flash_backward_phi3_train():
    # B 2, S 4096: 10 * 96 per pair and head; q, o, dO, dQ, k, v, dK, dV
    # of 2 * 4096 * 3072 bf16 values and the fp32 log-sum-exp of 2 * 32 * 4096
    flops, nbytes = counts.flash_bwd(2, 4096, 32, 32, 96, window=2047)
    assert flops == 10 * 96 * 6_290_431 * 2 * 32 == 386_484_080_640
    assert nbytes == 8 * 2 * 4096 * 3072 * 2 + 4 * 2 * 32 * 4096 == 403_701_760
    assert counts.flash_bwd(2, 4096, 32, 32, 96)[0] == 515_521_904_640


def test_decode_phi3():
    # B 16 against the 2047-slot ring, all valid, 32 heads of 96
    flops, nbytes = counts.decode(16, 2047, 2047, 32, 32, 96)
    assert flops == 4 * 96 * 2047 * 16 * 32 == 402_456_576
    assert nbytes == (2 * 16 * 2047 * 3072 + 2 * 16 * 3072) * 2 + 2047


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_train_step_flops_phi3():
    # per layer: attention 4 * 3072^2 = 37,748,736, MLP 3 * 3072 * 8192 =
    # 75,497,472; head 3072 * 32064 = 98,500,608; 8192 tokens; attention
    # 4 * 96 per pair and head over 32 layers, 2 rows; times 3
    per_token = 32 * (37_748_736 + 75_497_472) + 98_500_608
    fwd = 2 * 8192 * per_token + 4 * 96 * 32 * 6_290_431 * 2 * 32
    assert counts.train_step_flops(PHI3, 2, 4096) == 3 * fwd == 197_803_374_280_704
    fwd = 2 * 8192 * per_token + 4 * 96 * 32 * 8_390_656 * 2 * 32
    assert counts.train_step_flops(FULL, 2, 4096) == 3 * fwd == 202_758_426_722_304


def test_decode_step_phi3():
    b, valid = 16, 2047
    flops, nbytes = counts.decode_step(PHI3, b, valid)
    per_token = 32 * (37_748_736 + 75_497_472) + 98_500_608
    assert per_token == 3_722_379_264
    assert flops == 2 * b * per_token + 4 * 96 * 32 * valid * b * 32
    weights = (32 * 113_246_208 + 98_500_608) * 2 + 32 * 2 * 3072 * 4 \
        + 3072 * 4 + b * 3072 * 2
    kv = 32 * (2 * b * valid * 3072 + 2 * b * 3072) * 2
    assert nbytes == weights + kv


def _run(cfg, kind, profiled, trace):
    return types.SimpleNamespace(config=cfg, traffic={"kind": kind},
                                 profiled=profiled, traced=trace, spans={},
                                 device=None)


def test_mfu_train_reader():
    trace = Trace(window_s=2.0, busy_s=1.9,
                  device=[Activity("ampere_gemm", 0.0, 1.9)], gaps=[])
    r = _run(PHI3, "train", {"steps": 2, "batch": 2, "seq_len": 4096}, trace)
    want = 100 * 2 * 197_803_374_280_704 / 989e12 / 2.0
    assert harness.reader("mfu.train").read(r) == pytest.approx(want)
    assert harness.reader("device_idle.train").read(r) == pytest.approx(5.0)
    assert harness.reader("mfu.decode").read(r) is None


def test_flash_backward_reader():
    trace = Trace(window_s=2.0, busy_s=1.0, device=[
        Activity("void bwd_prep_kernel<bf16>", 0.0, 0.001),
        Activity("void bwd_wgmma_kernel<bf16, 128>", 0.001, 0.01),
        Activity("ampere_gemm", 0.02, 0.5)], gaps=[])
    r = _run(PHI3, "train", {"steps": 2, "batch": 2, "seq_len": 4096}, trace)
    need = 2 * 32 * counts.bound_s(386_484_080_640, 403_701_760)
    assert harness.reader("flash_bwd_roofline").read(r) == pytest.approx(
        100 * need / 0.011)


def _decode_trace(n_layers, gen, period):
    """decode_kernel calls of a warm-up step and gen - 1 replays, a step
    every ``period`` seconds, each call 1 ms."""
    acts = []
    for step in range(gen):
        for layer in range(n_layers):
            acts.append(Activity("void decode_kernel<bf16, 128>",
                                 step * period + layer * period / (2 * n_layers),
                                 0.001))
    return Trace(window_s=gen * period, busy_s=0.0, device=acts, gaps=[])


def test_decode_readers_count_each_steps_position():
    # no window: the warm-up step at position 100 sees 101 slots, the
    # replays at 100, 101, 102 see 101, 102, 103 of the 104 slots
    p = {"batch": 16, "prompt": 100, "gen": 4}
    r = _run(FULL, "serve_batch", p, _decode_trace(32, 4, 0.012))
    # replays start at 0.012 s intervals: two step periods, at 101 and 102
    need = sum(counts.bound_s(*counts.decode_step(FULL, 16, v)) for v in (101, 102))
    assert harness.reader("mfu.decode").read(r) == pytest.approx(
        100 * need / (2 * 0.012))
    need = 32 * sum(counts.bound_s(*counts.decode(16, 104, v, 32, 32, 96))
                    for v in (101, 101, 102, 103))
    assert harness.reader("decode_attention_roofline").read(r) == pytest.approx(
        100 * need / (32 * 4 * 0.001))


def test_decode_readers_phi3_and_a_count_that_does_not_fit():
    # every step sees the whole 2047-slot window
    p = {"batch": 16, "prompt": 3968, "gen": 3}
    r = _run(PHI3, "serve_batch", p, _decode_trace(32, 3, 0.02))
    need = counts.bound_s(*counts.decode_step(PHI3, 16, 2047))
    assert harness.reader("mfu.decode").read(r) == pytest.approx(100 * need / 0.02)
    need = 32 * 3 * counts.bound_s(*counts.decode(16, 2047, 2047, 32, 32, 96))
    assert harness.reader("decode_attention_roofline").read(r) == pytest.approx(
        100 * need / (32 * 3 * 0.001))
    odd = Trace(window_s=1.0, busy_s=0.5, device=r.traced.device[:-1], gaps=[])
    assert harness.reader("mfu.decode").read(_run(PHI3, "serve_batch", p, odd)) is None
    assert harness.reader("decode_attention_roofline").read(
        _run(PHI3, "serve_batch", p, odd)) is None


def test_flash_forward_reader_phi3():
    trace = Trace(window_s=1.0, busy_s=0.5, device=[
        Activity("void flash_tc_kernel<bf16, 128>", 0.0, 0.01)] * 32, gaps=[])
    p = {"batch": 16, "prompt": 3968, "gen": 128}
    r = _run(PHI3, "serve_batch", p, trace)
    need = 32 * counts.bound_s(1_185_234_616_320, 1_560_281_088)
    assert harness.reader("flash_fwd_roofline.serve").read(r) == pytest.approx(
        100 * need / 0.32)
    assert harness.reader("flash_fwd_roofline.serve").read(
        _run(PHI3, "train", p, trace)) is None


def test_span_readers():
    spans = [{"decode_s": 2.0, "decode_steps": 100, "decode_capture_s": 0.1},
             {"decode_s": 3.0, "decode_steps": 150, "decode_capture_s": 0.3}]
    r = types.SimpleNamespace(spans={"serve": spans})
    assert harness.reader("decode_step_ms").read(r) == pytest.approx(20.0)
    assert harness.reader("capture_ms").read(r) == pytest.approx(200.0)
    assert harness.reader("capture_ms").read(types.SimpleNamespace(spans={})) is None
