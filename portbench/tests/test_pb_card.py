"""One short run of a cell on the card (skipped on the CPU)."""
import json
import subprocess
import sys

import pytest

from portbench.lib.cell import ROOT


@pytest.mark.card
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "aspire-pool-ot",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert list(result)[-1] == "checks"
