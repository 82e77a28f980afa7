"""The port's utils/profiling.py against the JAX package's: PhaseTimer keeps
the same counts and summary layout for the same phases (times are the
host's, so only their consistency is held: mean = total / count within 1e-6
after the same rounding); `trace` labels a block with record_function
inside an enclosing torch.profiler trace, and with a log_dir writes a
torch.profiler trace there."""
import json
import logging
import time

import pytest
import torch

from aspire_tpu.utils import profiling as jprof
from aspire_tpu_torch.utils import profiling as tprof

PHASES = ["encode", "score", "encode", "encode", "rerank", "score"]


def timed(timer, phases, fail_on=None):
    for name in phases:
        try:
            with timer(name):
                time.sleep(0.001)
                if name == fail_on:
                    raise ValueError(name)
        except ValueError:
            pass
    return timer.summary()


@pytest.mark.parametrize("fail_on", [None, "score"])
def test_phase_timer_counts_match_jax(fail_on):
    got = timed(tprof.PhaseTimer(), PHASES, fail_on)
    want = timed(jprof.PhaseTimer(), PHASES, fail_on)
    assert list(got) == list(want) == ["encode", "score", "rerank"]
    for name in got:
        assert set(got[name]) == set(want[name]) == {"total_s", "count", "mean_s"}
        assert got[name]["count"] == want[name]["count"] == PHASES.count(name)
        assert got[name]["total_s"] >= 0.001 * got[name]["count"]
        assert abs(got[name]["mean_s"]
                   - got[name]["total_s"] / got[name]["count"]) <= 1e-6


def test_phase_timer_log_summary(caplog):
    timer = tprof.PhaseTimer()
    timed(timer, PHASES)
    with caplog.at_level(logging.INFO, logger=tprof.__name__):
        timer.log_summary()
    assert sum("phase encode" in r.getMessage() for r in caplog.records) == 1
    assert len(caplog.records) == 3


@pytest.mark.parametrize("name", [None, "encode_block"])
def test_trace_labels_a_block(name):
    x = torch.randn(16, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.trace(name=name):
            (x @ x).sum()
    keys = {e.key for e in prof.key_averages()}
    assert (name or "aspire_block") in keys
    assert "aten::mm" in keys


def test_trace_writes_a_trace_to_log_dir(tmp_path):
    x = torch.randn(32, 32)
    with tprof.trace(str(tmp_path / "tb")):
        with tprof.trace(name="inner"):
            (x @ x).relu()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "inner" in names and "aten::mm" in names
