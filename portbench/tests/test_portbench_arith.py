"""The yardstick's arithmetic against counts made by hand, and the window's
numbers against a window with a stall in it."""

import pytest

from portbench import flops
from portbench.harness import window_metrics


def test_bert_flops_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "vocab_size": 10,
           "num_hidden_layers": 2}
    b, l, masked = 3, 5, 2
    t = b * l
    layer = 4 * (2 * t * 4 * 4) + 2 * (2 * t * 4 * 8) + 2 * (2 * b * l * l * 4)
    heads = 2 * masked * 4 * 4 + 2 * masked * 4 * 10 + 2 * b * 4 * 4 \
        + 2 * b * 4 * 2
    assert flops.bert_step_flops(cfg, b, l, masked) == 3 * (2 * layer + heads)


def test_bart_flops_by_hand():
    cfg = {"d_model": 4, "encoder_ffn_dim": 8, "decoder_ffn_dim": 6,
           "vocab_size": 10, "encoder_layers": 1, "decoder_layers": 2}
    b, le, ld = 2, 5, 3
    enc = 4 * 2 * b * le * 16 + 2 * 2 * b * le * 32 + 2 * 2 * b * le * le * 4
    dec = (4 * 2 * b * ld * 16 + 2 * 2 * b * ld * 16 + 2 * 2 * b * le * 16
           + 2 * 2 * b * ld * 24 + 2 * 2 * b * ld * ld * 4
           + 2 * 2 * b * ld * le * 4)
    head = 2 * b * ld * 4 * 10
    assert flops.bart_step_flops(cfg, b, le, ld) == 3 * (enc + 2 * dec + head)


def test_kernel_work_counts_valid_rows():
    nbytes, ops = flops.kernel_work("onekv_fwd", [3, 1], heads=2, head_dim=4)
    assert ops == 2 * 2.0 * (9 + 1) * 2 * 4
    assert nbytes == 4 * 4 * 2 * 4 * 2 + 1 * 4 * 2 * 4 + 2 * 4 * 4
    b_bytes, b_ops = flops.kernel_work("onekv_bwd", [3, 1], 2, 4)
    assert b_ops == 5 / 2 * ops
    t, by = flops.bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_p95():
    assert flops.p95(range(101)) == pytest.approx(95.0)
    assert flops.p95([2.0]) == 2.0


class _Mark:
    def __init__(self, t):
        self.t = t


def _window(times, tokens=100, fl=1e12):
    marks = [_Mark(t) for t in times[:-1]]
    stats = [{"tokens": tokens, "flops": fl}] * len(marks)
    return window_metrics(marks, _Mark(times[-1]), stats,
                          lambda a, b: b.t - a.t)


def test_rate_and_tail_over_every_step():
    steady = _window([0.1 * i for i in range(101)])
    assert steady["steps"] == 100
    assert steady["train_tokens_per_s"] == pytest.approx(1000.0)
    assert steady["step_ms_p95"] == pytest.approx(100.0)
    assert steady["mfu"] == pytest.approx(100 * 1e13 / 989e12)
    # ten steps stalled by 0.5 s: the rate falls by the stall, and the
    # tail, which counts every step, shows it
    times = [0.0]
    for i in range(100):
        times.append(times[-1] + 0.1 + (0.5 if i % 10 == 3 else 0.0))
    stalled = _window(times)
    assert stalled["train_tokens_per_s"] == pytest.approx(1e4 / 15.0)
    assert stalled["step_ms_p95"] == pytest.approx(600.0)
    assert stalled["mfu"] < steady["mfu"]
