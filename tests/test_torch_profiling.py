"""The port's utils/profiling.py: a span labels a block `aspire:<name>` as a
host event inside an enclosing torch.profiler trace, and `trace(log_dir)`
writes a torch.profiler trace there, the spans' labels in it."""
import json

import pytest
import torch

from aspire_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("name", ["scan", "encode_block"])
def test_trace_labels_a_block(name):
    x = torch.randn(16, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.span(name):
            (x @ x).sum()
    keys = {e.key for e in prof.key_averages()}
    assert f"aspire:{name}" in keys
    assert "aten::mm" in keys
    tprof.reset()


def test_trace_writes_a_trace_to_log_dir(tmp_path):
    x = torch.randn(32, 32)
    with tprof.trace(str(tmp_path / "tb")):
        with tprof.span("inner"):
            (x @ x).relu()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aspire:inner" in names and "aten::mm" in names
    assert [r["name"] for r in tprof.records()] == ["inner"]
    tprof.reset()
