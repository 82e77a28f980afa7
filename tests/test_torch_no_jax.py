"""The port stands alone: importing `aspire_tpu_torch` and every submodule
pulls in no jax, flax, optax, orbax or aspire_tpu module, and needs neither nvcc nor
triton; `chip_smoke.py` imports none of them either."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "aspire_tpu")

PROBE = r"""
import importlib, pkgutil, sys
import aspire_tpu_torch
names = ["aspire_tpu_torch"]
for m in pkgutil.walk_packages(aspire_tpu_torch.__path__, "aspire_tpu_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "aspire_tpu"))
assert not bad, bad
assert "triton" not in sys.modules
must = {"aspire_tpu_torch.core.types", "aspire_tpu_torch.ops.cdist",
        "aspire_tpu_torch.ops.sinkhorn", "aspire_tpu_torch.ops.sinkhorn_kernel",
        "aspire_tpu_torch.ops.attention_kernel", "aspire_tpu_torch.ops.ffn_kernel",
        "aspire_tpu_torch.ops._build", "aspire_tpu_torch.ops.distances",
        "aspire_tpu_torch.models.bert", "aspire_tpu_torch.models.encoders",
        "aspire_tpu_torch.models.convert", "aspire_tpu_torch.index.serve",
        "aspire_tpu_torch.core.config", "aspire_tpu_torch.ops.philox",
        "aspire_tpu_torch.ops.dropout_kernel", "aspire_tpu_torch.models.layers",
        "aspire_tpu_torch.models.doc_models", "aspire_tpu_torch.models.sent_models",
        "aspire_tpu_torch.train.schedules", "aspire_tpu_torch.train.trainer",
        "aspire_tpu_torch.train.predict_utils", "aspire_tpu_torch.utils.checkpoint"}
assert must <= set(names), must - set(names)
print("IMPORTED", len(names))
"""


def test_package_imports_without_jax_nvcc_or_triton(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    # an empty PATH entry list hides any nvcc: importing must not look for it
    env["PATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted((REPO / "aspire_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "aspire_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "sinkhorn.cu", "attention.cu", "attention_bwd.cu", "dropout.cu", "ffn.cu"}
    text = (REPO / "pyproject.toml").read_text()
    assert "aspire_tpu_torch" in text and "csrc" in text
    from aspire_tpu_torch.ops import _build
    assert set(_build.sources()) == set(csrc.glob("*.cu"))
    assert "compute_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
