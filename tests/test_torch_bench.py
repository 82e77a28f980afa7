"""The port's twin of the headline benchmark (benchmarks/torch_bench.py, the
twin of bench.py): its workload and scoring call against the JAX package's
`wasserstein_dist(solver="xla")` on the same numpy reps at 16 pairs, and the
script run with --device cpu, whose last line carries exactly bench.py's
keys."""
import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from aspire_tpu.core.types import MultiVec as JMV
from aspire_tpu.ops.distances import wasserstein_dist as jax_wasserstein

REPO = pathlib.Path(__file__).resolve().parent.parent
# OT scores pass through ~70 annealing rounds and exp((f + g - C) / blur)
# (tests/test_torch_distances.py)
OT_TOL = dict(rtol=2e-3, atol=2e-3)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed_keys(path: pathlib.Path) -> list:
    """The key lists of the dict literals with a "metric" key in a script:
    the JSON lines it prints."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                found.append(keys)
    return found


def run_cpu(script: str, *argv: str) -> list:
    """The script's JSON lines, run as a subprocess with --device cpu."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, str(REPO / "benchmarks" / script),
                           "--device", "cpu", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [json.loads(ln) for ln in proc.stdout.splitlines()]


def test_headline_scores_match_jax():
    bench = load_script("torch_bench")
    q, c = bench.draw_pairs(16, 0, "cpu")
    assert tuple(q.embed.shape) == (16, 20, 768)
    assert int(q.lens.min()) >= 4 and int(c.lens.max()) <= 20
    got = bench.score(q, c)                 # on the CPU: the kernel's plain version
    want, _ = jax_wasserstein(
        JMV(jnp.asarray(q.embed.numpy()), jnp.asarray(q.lens.numpy())),
        JMV(jnp.asarray(c.embed.numpy()), jnp.asarray(c.lens.numpy())),
        blur=0.05, scaling=0.9, temp=5000.0, return_pair_sims=True, solver="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OT_TOL)
    np.testing.assert_allclose(bench.score(q, c, "torch").numpy(), np.asarray(want),
                               **OT_TOL)


def test_headline_script_prints_bench_keys():
    want = printed_keys(REPO / "bench.py")
    assert want == [["metric", "value", "unit", "vs_baseline"]]
    lines = run_cpu("torch_bench.py", "--batch", "8")
    assert list(lines[-1]) == want[0]
    assert lines[-1]["metric"] == "sinkhorn_pair_scorings_per_sec_per_chip"
    assert lines[-1]["unit"] == "pairs/s"
    # a CPU run measures no card
    assert lines[-1]["value"] is None and lines[-1]["vs_baseline"] is None
    assert lines[0]["pairs"] == 8 and lines[0]["device"] == "cpu"
