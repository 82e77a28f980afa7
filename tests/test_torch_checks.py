"""The port's end-to-end checks: benchmarks/torch_convergence_check.py runs
small on the CPU (2 layers at BERT-base width, 8 steps) with finite losses
and its descent condition is the JAX script's; scripts/torch_int8_validation.py
and scripts/int8_validation.py, both `--from-index` on one f32 index built by
the port, print the same summary (containment and top-1 equal)."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from aspire_tpu_torch.index.dense import build_dense_index

REPO = pathlib.Path(__file__).resolve().parent.parent


def load(path: str):
    spec = importlib.util.spec_from_file_location(
        "probe_" + pathlib.Path(path).stem, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def convergence():
    return load("benchmarks/torch_convergence_check.py")


def test_convergence_check_runs_small_with_finite_losses(convergence):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = convergence.parse_args(["--layers", "2", "--steps", "8",
                                       "--tokens", "64", "--device", "cpu"])
        log, seconds = convergence.train(args)
    finally:
        torch.set_num_threads(n)
    assert len(log) == 2 and all(np.isfinite(log)) and seconds > 0


def test_convergence_condition_is_the_jax_scripts(convergence):
    convergence.check_descent([12.0, 11.0, 9.0, 9.5, 9.8])     # 9.0 < 9.6
    with pytest.raises(AssertionError, match="did not decrease"):
        convergence.check_descent([12.0, 11.0, 9.7, 9.8, 10.0])
    with pytest.raises(AssertionError, match="non-finite"):
        convergence.check_descent([12.0, float("nan"), 1.0])


def test_convergence_data_is_the_jax_scripts(convergence):
    """The same draws from np.random.default_rng(0) as the JAX script's
    topic_tokens / feats / superbatch code, in its order."""
    rng = np.random.default_rng(0)
    sb = convergence.Triples(0).superbatch()
    topics = rng.permutation(64)[:16].reshape(2, 8)
    for side in ("query", "pos"):
        for m in range(2):
            for b in range(8):
                base = 5 + (topics[m, b] * 997) % 25000
                want = (base + rng.integers(0, 2000, 256)) % 30000
                np.testing.assert_array_equal(sb[side]["token_ids"][m, b], want)
        np.testing.assert_array_equal(
            sb[side]["sent_ids"],
            np.clip(rng.integers(-1, 20, (2, 8, 256)), -1, 19))
        np.testing.assert_array_equal(sb[side]["abs_lens"],
                                      rng.integers(3, 21, (2, 8)))
    np.testing.assert_array_equal(sb["pos"]["align"], rng.integers(0, 20, (2, 8, 2)))


@pytest.fixture(scope="module")
def f32_index(tmp_path_factory):
    """An f32 index of strongly anisotropic reps (8 x a shared offset plus
    unit noise, 3-12 sentences of 64; mean cosine about 0.98, so that int8
    misses some of the exact top 10), built and saved by the port."""
    rng = np.random.default_rng(11)
    offset = rng.standard_normal(64).astype(np.float32)
    reps = [(8 * offset + rng.standard_normal((int(n), 64))).astype(np.float32)
            for n in rng.integers(3, 13, 330)]
    idx = build_dense_index(reps, [f"d{i}" for i in range(len(reps))],
                            dtype="float32")
    path = tmp_path_factory.mktemp("int8") / "index"
    idx.save(path)
    return path


def test_int8_validation_equals_the_jax_script(f32_index, capsys):
    flags = ["--from-index", str(f32_index), "--n-docs", "300", "--n-queries",
             "12", "--k-exact", "10", "--margins", "10,12,16", "--final-k", "5"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "scripts/int8_validation.py", *flags],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = load("scripts/torch_int8_validation.py").main([*flags, "--device", "cpu"])
    got = json.loads(json.dumps(got))         # int keys as the JSON line has them
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got["containment_top50_in_int8_topM"] == want["containment_top50_in_int8_topM"]
    assert got["containment_min_topM"] == want["containment_min_topM"]
    assert got["top1_agreement_int8_stage1"] == want["top1_agreement_int8_stage1"]
    assert got["containment_min_topM"]["10"] < 1.0    # the case is not trivial
    assert got == want
