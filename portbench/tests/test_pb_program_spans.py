"""The six readers of the program's own spans (`lib/program.py`) over records
the program makes under `recording()` while the kinds call their entries at
small sizes.  A CPU run records no device time, so the card's is stood in by
the host's to read the ms metrics; with the CPU's own records, or none, every
reader gives None."""
import functools

import pytest
import torch

from aspire_tpu_torch.utils import profiling
from portbench.lib import program
from portbench.lib.cell import cell_spec, load_module
from portbench.tests import tiny

READS = {  # metric -> (roots, spans, count) it sums a call
    "scan_ms": (("fused_query",), "scan", None),
    "scan_ms.single": (("fused_query",), "scan", None),
    "gather_ms": (("fused_query", "pool_rank"), "gather", None),
    "gather_mb": (("fused_query", "pool_rank"), "gather", "bytes"),
    "rerank_ms": (("fused_query", "pool_rank"), "rerank", None),
    "rerank_ms.single": (("fused_query", "pool_rank"), "rerank", None),
}
CASES = [("scan_ms", "aspire-1m-b32"), ("scan_ms.single", "aspire-1m-b1"),
         ("gather_ms", "aspire-1m-b32"), ("gather_ms", "aspire-pool-ot"),
         ("gather_mb", "aspire-1m-b32"), ("gather_mb", "aspire-pool-ot"),
         ("rerank_ms", "aspire-1m-b32"), ("rerank_ms", "aspire-pool-ot"),
         ("rerank_ms.single", "aspire-1m-b1")]


@functools.lru_cache(maxsize=None)
def recorded(cell: str, calls: int = 3) -> tuple:
    """The records of `calls` calls of the cell's entry at the tests' sizes."""
    spec = cell_spec(cell)
    cfg = {**spec["config_spec"], **tiny.CONFIG}
    traffic = {**spec["traffic_spec"], **tiny.TRAFFIC[cell]}
    state = load_module("kinds", traffic["kind"]).setup(cfg, traffic, 2**40 + 7,
                                                        torch.device("cpu"))
    profiling.reset()
    with profiling.recording():
        for i in range(calls):
            state.step(i)
    recs = profiling.records()
    profiling.reset()
    return tuple(recs)


def as_on_card(recs):
    return [dict(r, device_ms=r["host_ms"]) for r in recs]


@pytest.mark.parametrize("metric,cell", CASES)
def test_reader_sums_a_call_and_averages_the_calls(monkeypatch, metric, cell):
    recs = as_on_card(recorded(cell))
    monkeypatch.setattr(program, "records", lambda: recs)
    roots, name, count = READS[metric]
    calls = [r for r in recs if r["parent"] is None and r["name"] in roots]
    assert len(calls) == 3
    per_call = [sum(r["device_ms"] if count is None else r["counts"][count]
                    for r in recs if r["call"] == c["id"] and r["name"] == name)
                for c in calls]
    want = sum(per_call) / 3 / (1e6 if count else 1)
    assert load_module("metrics", metric).read(None) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cell,bytes_a_call", [
    # 4 queries x k 8 candidates x (4 + 8) sentences x (64 int8 + an f32 scale)
    ("aspire-1m-b32", 4 * 8 * (4 + 8) * (64 + 4)),
    # 2 queries x pools of 16 x 6 sentences x 64 bf16
    ("aspire-pool-ot", 2 * 16 * 6 * 64 * 2)])
def test_gather_mb_is_the_shape_arithmetic(monkeypatch, cell, bytes_a_call):
    recs = as_on_card(recorded(cell))
    monkeypatch.setattr(program, "records", lambda: recs)
    assert load_module("metrics", "gather_mb").read(None) == bytes_a_call / 1e6


@pytest.mark.parametrize("metric", sorted(READS))
def test_readers_read_nothing_without_card_records(monkeypatch, metric):
    profiling.reset()
    assert load_module("metrics", metric).read(None) is None
    cell = "aspire-1m-b1" if metric.endswith(".single") else "aspire-1m-b32"
    cpu = list(recorded(cell))
    assert cpu and all(r["device_ms"] is None for r in cpu)
    monkeypatch.setattr(program, "records", lambda: cpu)
    assert load_module("metrics", metric).read(None) is None
