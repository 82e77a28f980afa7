"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""
import subprocess
import sys

import pytest

from portbench.lib.cell import ROOT, forbidden_modules

PROGRAM_OR_JAX = ("aspire_tpu_torch", "aspire_tpu", "jax", "jaxlib", "flax")


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_names_compare_whole():
    assert forbidden_modules(["aspire_tpu_torch", "aspire_tpu_torch.ops", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["aspire_tpu.ops", "jax.numpy", "flax"]) == \
        ["aspire_tpu", "flax", "jax"]


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import portbench.reference.bert, portbench.reference.ot, portbench.reference.search\n"
        f"print([m for m in sys.modules if m.split('.')[0] in {PROGRAM_OR_JAX!r}])\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    out = _python(
        "import sys\n"
        "from portbench.tests import tiny\n"
        "from portbench.lib.cell import forbidden_modules\n"
        "for cell in tiny.CELLS:\n"
        "    tiny.run(cell, trace=True)\n"
        "print(forbidden_modules(), 'aspire_tpu_torch' in sys.modules)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is not reachable")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "aspire-pool-ot",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr
