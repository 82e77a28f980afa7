"""The port stands alone: importing `aspire_tpu_torch` and every submodule
pulls in no jax, flax, optax, orbax, ml_dtypes, transformers, tokenizers,
regex, pandas, h5py, safetensors or aspire_tpu module, and needs neither nvcc
nor triton; `chip_smoke.py`, the port's benchmark scripts, its chain,
int8, 1M-document serving and several-machine worker scripts
(scripts/torch_*.py), examples (examples/*_torch.py) and the code cells of
its notebooks (examples/*_torch.ipynb) import none of them either
(h5py only inside `SimilarityModel.set_encodings_cache`, which the card's
machine never calls: it has no h5py)."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "aspire_tpu", "ml_dtypes",
          "transformers", "tokenizers", "regex", "pandas", "safetensors")

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
                                    "aspire_tpu", "ml_dtypes", "transformers",
                                    "tokenizers", "regex", "pandas", "h5py",
                                    "safetensors"))
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
        "aspire_tpu_torch.train.predict_utils", "aspire_tpu_torch.utils.checkpoint",
        "aspire_tpu_torch.ops.pool_kernel", "aspire_tpu_torch.ops.scan_kernel",
        "aspire_tpu_torch.text.tokenize", "aspire_tpu_torch.index.build",
        "aspire_tpu_torch.index.dense", "aspire_tpu_torch.index.cls",
        "aspire_tpu_torch.data.readers", "aspire_tpu_torch.text.fast",
        "aspire_tpu_torch.evaluation.metrics", "aspire_tpu_torch.evaluation.datasets",
        "aspire_tpu_torch.evaluation.protocols",
        "aspire_tpu_torch.evaluation.ranking_eval",
        "aspire_tpu_torch.evaluation.models", "aspire_tpu_torch.evaluation.evaluate",
        "aspire_tpu_torch.evaluation.diagnostics", "aspire_tpu_torch.cli",
        "aspire_tpu_torch.__main__", "aspire_tpu_torch.data.preprocess",
        "aspire_tpu_torch.data.gorc", "aspire_tpu_torch.data.corpus",
        "aspire_tpu_torch.data.mix", "aspire_tpu_torch.data.ner",
        "aspire_tpu_torch.data.align", "aspire_tpu_torch.utils.profiling",
        "aspire_tpu_torch.text.bpe", "aspire_tpu_torch.models.mpnet",
        "aspire_tpu_torch.parallel", "aspire_tpu_torch.parallel.mesh"}
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
    tree = ast.parse(_code(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _code(path: pathlib.Path) -> str:
    """A source file's text; a notebook's code cells, one after another."""
    if path.suffix != ".ipynb":
        return path.read_text()
    cells = json.loads(path.read_text())["cells"]
    return "\n".join("".join(c["source"]) for c in cells if c["cell_type"] == "code")


SOURCES = (sorted((REPO / "aspire_tpu_torch").rglob("*.py"))
           + [REPO / "chip_smoke.py"]
           + sorted((REPO / "scripts").glob("torch_*.py"))
           + sorted((REPO / "benchmarks").glob("torch_*.py"))
           + sorted((REPO / "examples").glob("*_torch.py"))
           + sorted((REPO / "examples").glob("*_torch.ipynb")))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_h5py_only_inside_the_encodings_cache():
    """The h5 encodings cache keeps its file contract through a lazy import;
    nothing else in the port imports h5py."""
    where = []
    for path in SOURCES:
        tree = ast.parse(_code(path))
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.Module)):
                continue
            body = fn.body if isinstance(fn, ast.FunctionDef) else [
                n for n in fn.body if not isinstance(n, (ast.FunctionDef,
                                                         ast.ClassDef))]
            for node in body:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Import) and any(
                            a.name.split(".")[0] == "h5py" for a in sub.names):
                        where.append((path.name, getattr(fn, "name", "<module>")))
    assert where == [("models.py", "set_encodings_cache")]


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "aspire_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "sinkhorn.cu", "attention.cu", "attention_bwd.cu",
        "dropout.cu", "ffn.cu", "pool.cu", "scan.cu", "scan_int8.cu"}
    text = (REPO / "pyproject.toml").read_text()
    assert "aspire_tpu_torch" in text and "csrc" in text
    from aspire_tpu_torch.ops import _build
    assert set(_build.sources()) == set(csrc.glob("*.cu"))
    assert "compute_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    for name in ("aspire_pool_bf16", "aspire_pool_f32", "aspire_scan_bf16",
                 "aspire_scan_int8"):
        assert name in _build.SIGNATURES


SCRIPT_PROBE = r"""
import importlib.util, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("probe_" + str(len(sys.modules)), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "aspire_tpu", "ml_dtypes", "transformers",
                                    "tokenizers", "regex"))
assert not bad, bad
assert "triton" not in sys.modules
print("IMPORTED", len(sys.argv) - 1)
"""


def test_scripts_import_without_jax(tmp_path):
    """Importing chip_smoke.py and the index profile script (not running
    them) pulls in none of the banned packages."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    scripts = [REPO / "chip_smoke.py", REPO / "benchmarks" / "torch_index_profile.py"]
    proc = subprocess.run([sys.executable, "-c", SCRIPT_PROBE, *map(str, scripts)],
                          env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED 2" in proc.stdout
