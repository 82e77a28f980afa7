"""The yardstick's arithmetic at shapes worked by hand."""
import math

import pytest

from portbench.lib import peaks, work
from portbench.lib.cell import load_module
from portbench.lib.trace import Trace

ENC = {"tokens": [10, 20], "seq": 32, "layers": 2, "hidden": 4, "ffn": 8, "heads": 2}
SCAN = {"q_sents": [2, 3], "qmax": 4, "dim": 8, "buckets": [[2, 3]], "doc_sents": 7}
RERANK = {"n": [2], "m": [3], "n_pad": 4, "m_pad": 5, "iters": [4], "dim": 8}


def test_encoder_counts():
    # 2 layers x 2 x 30 tokens x (4 h^2 + 2 h f) = 2 x 2 x 30 x 128
    assert work.encoder_linear_ops(ENC) == 15360
    # 2 layers x 4 x (10^2 + 20^2) x h
    assert work.encoder_attention_ops(ENC) == 16000
    assert work.encoder_seconds(ENC) == pytest.approx(31360 / peaks.PEAK_BF16)
    assert work.ffn_ops(ENC) == 4 * 30 * 4 * 8
    # x and out: 2 docs x 32 rows x 4 wide; weights 2 x 4 x 8; biases 4 + 8; bf16
    assert work.ffn_bytes(ENC) == 2 * (2 * 64 * 4 + 2 * 32 + 12)
    assert work.attention_ops(ENC) == 4 * 500 * 4
    assert work.attention_bytes(ENC) == 4 * 2 * 2 * 32 * 4 + 4 * 2 * 32


def test_scan_counts():
    assert work.scan_ops(SCAN) == 2 * 5 * 7 * 8
    # 6 rows x (8 int8 + norm + scale); the query 2 x 4 x 8 f32, scores 2 x 2 f32
    assert work.scan_bytes(SCAN) == 6 * 16 + 4 * 2 * (32 + 2)
    assert work.scan_seconds(SCAN) == pytest.approx(
        max(work.scan_bytes(SCAN) / peaks.PEAK_BYTES, 560 / peaks.PEAK_BF16))


def test_rerank_counts():
    # (4 schedule rounds + the first + the final) x (2 x 2 x 3 + 2 + 3)
    assert work.sinkhorn_terms(RERANK) == 6 * 17
    assert work.sinkhorn_bytes(RERANK) == 4 * (20 + 2 * 9 + 1)
    assert work.cost_ops(RERANK) == 2 * 6 * 8
    assert work.rerank_seconds(RERANK) == pytest.approx(
        96 / peaks.PEAK_F32_PRODUCT + 102 / peaks.PEAK_SFU)


def test_schedule_len():
    # log(0.05) / log(0.9) = 28.4 -> 29 + 2 rounds, capped
    assert work.schedule_len([1.0], 0.05, 0.9, 128).tolist() == [31.0]
    assert work.schedule_len([1.0], 0.05, 0.9, 20).tolist() == [20.0]
    assert work.schedule_len([0.01], 0.05, 0.9, 128).tolist() == [2.0]


def test_peaks():
    assert peaks.PEAK_F32_PRODUCT == pytest.approx(165e12)
    assert peaks.PEAK_SFU == pytest.approx(67e12 / 16)
    assert peaks.least_seconds(3.35e12, 0, 1) == pytest.approx(1.0)


def test_trace_union_and_gaps():
    t = Trace(ops=[("a", 0.0, 1.0), ("b", 0.5, 2.0), ("Memcpy DtoH", 3.0, 4.0)], calls=2)
    assert t.window_s == 4.0
    assert t.busy_s == 3.0
    assert t.seconds("^a$") == 1.0
    assert t.count(r"^(?!Memcpy|Memset)") == 2
    assert t.top_ops(1) == [["b", 1.5]]


class _Run:
    def __init__(self, trace, work_):
        self.trace, self.work, self.spans = trace, work_, {}


def test_readers():
    calls = [{"encoder": ENC, "scan": SCAN, "rerank": RERANK}] * 2
    trace = Trace(ops=[("void scan_wide_kernel<signed char, true>", 0.0, 0.25),
                       ("sinkhorn_small_kernel<6>", 0.25, 0.5),
                       ("ffn_bf16_kernel<0>", 0.5, 0.75),
                       ("attention_bf16_kernel<64, 0>", 0.75, 1.0)], calls=2)
    run = _Run(trace, calls)
    scan = load_module("metrics", "scan_roofline").read(run)
    assert scan == pytest.approx(100 * 2 * work.scan_seconds(SCAN) / 0.25)
    sink = load_module("metrics", "sinkhorn_roofline").read(run)
    assert sink == pytest.approx(100 * 2 * work.sinkhorn_seconds(RERANK) / 0.25)
    mfu = load_module("metrics", "mfu.query").read(run)
    need = work.encoder_seconds(ENC) + work.scan_seconds(SCAN) + work.rerank_seconds(RERANK)
    assert mfu == pytest.approx(100 * 2 * need / 1.0)
    ffn = load_module("metrics", "ffn_roofline.encode").read(run)
    assert ffn == pytest.approx(100 * 2 * 2 * peaks.least_seconds(
        work.ffn_bytes(ENC), work.ffn_ops(ENC), peaks.PEAK_BF16) / 0.25)
    assert load_module("metrics", "idle_share.query").read(run) == pytest.approx(0.0)
    assert load_module("metrics", "launches.query").read(run) == 2.0
    # a reader with nothing to read returns nothing, never 0
    empty = _Run(Trace(ops=[("other", 0.0, 1.0)], calls=1), calls)
    assert load_module("metrics", "scan_roofline").read(empty) is None
    assert load_module("metrics", "mfu.query").read(_Run(None, calls)) is None
    assert not math.isnan(mfu)
