"""The several-machine protocol of the port, executed: the two worker
scripts (scripts/torch_multihost_worker.py, torch_multihost_serve_worker.py)
as two processes that meet through a file:// init method and train or serve
over gloo on the CPU, against the same worker as one process.

As tests/test_multihost_dcn.py holds the JAX workers: the processes agree bit
for bit (parameters, losses, dev scores, search results); training matches
one process within 2e-4 in losses and dev scores and 5e-4 in parameters;
serving matches it exactly in ids, within 1e-6 in scores and 1e-5 in pool
scores; rank 0 alone wrote the shared run directory, whose checkpoint holds
the processes' parameters.  scripts/torch_serve_1m_mesh.py runs beside them
at 3,000 documents.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAIN = REPO / "scripts" / "torch_multihost_worker.py"
SERVE = REPO / "scripts" / "torch_multihost_serve_worker.py"
MERGE_1M = REPO / "scripts" / "torch_serve_1m_mesh.py"
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _start(worker, out_dir: pathlib.Path, n: int) -> list:
    out_dir.mkdir(parents=True)
    init = "file://" + str(out_dir / "rendezvous")
    return [subprocess.Popen(
        [sys.executable, str(worker), "--coordinator", init,
         "--num-processes", str(n), "--process-id", str(i), "--out",
         str(out_dir), "--device", "cpu"], env=ENV, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    procs = {(w.stem, n): _start(w, root / f"{w.stem}-{n}", n)
             for w in (TRAIN, SERVE) for n in (2, 1)}
    procs["1m"] = [subprocess.Popen(
        [sys.executable, str(MERGE_1M), "--docs", "3000", "--queries", "2",
         "--ranks", "2", "--device", "cpu"], env=ENV, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    logs = {}
    for key, ps in procs.items():
        for i, p in enumerate(ps):
            log = p.communicate(timeout=600)[0]
            assert p.returncode == 0, (key, i, log[-4000:])
            logs[key] = log
    return root, logs


def _train_dumps(d: pathlib.Path, n: int):
    return ([json.loads((d / f"summary-proc{i}.json").read_text())
             for i in range(n)],
            [dict(np.load(d / f"params-proc{i}.npz")) for i in range(n)])


def test_two_process_training_matches_one_process(jobs):
    jobs, _ = jobs
    two_dir = jobs / "torch_multihost_worker-2"
    sums, params = _train_dumps(two_dir, 2)
    one_sums, one_params = _train_dumps(jobs / "torch_multihost_worker-1", 1)
    assert sums[0]["world_size"] == 2 and one_sums[0]["world_size"] == 1
    for k in params[0]:
        np.testing.assert_array_equal(params[0][k], params[1][k], err_msg=k)
    for key in ("losses", "dev_scores", "best_score"):
        assert sums[0][key] == sums[1][key]
        np.testing.assert_allclose(sums[0][key], one_sums[0][key], rtol=2e-4,
                                   atol=2e-4)
    assert one_params[0].keys() == params[0].keys()
    for k in params[0]:
        np.testing.assert_allclose(params[0][k], one_params[0][k], rtol=5e-4,
                                   atol=5e-4, err_msg=k)
    # rank 0 alone wrote the shared run directory
    lines = (two_dir / "run" / "metrics.jsonl").read_text().splitlines()
    one_lines = (jobs / "torch_multihost_worker-1" / "run" /
                 "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(one_lines)
    saved = torch.load(two_dir / "run" / "model_final.pt", weights_only=True)
    assert saved.keys() == params[0].keys()
    for k in saved:
        np.testing.assert_array_equal(saved[k].numpy(), params[0][k],
                                      err_msg=k)


def test_two_process_serving_matches_one_process(jobs):
    jobs, _ = jobs
    two = [dict(np.load(jobs / "torch_multihost_serve_worker-2" /
                        f"serve-proc{i}.npz")) for i in range(2)]
    one = dict(np.load(jobs / "torch_multihost_serve_worker-1" /
                       "serve-proc0.npz"))
    summary = json.loads((jobs / "torch_multihost_serve_worker-2" /
                          "serve-summary-proc0.json").read_text())
    assert summary == {"process_count": 2, "world_size": 2}
    for k in two[0]:
        np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=k)
    np.testing.assert_array_equal(two[0]["docs"], one["docs"])
    np.testing.assert_allclose(two[0]["scores"], one["scores"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(two[0]["pool_sims"], one["pool_sims"],
                               rtol=1e-5, atol=1e-5)


def test_the_1m_merge_script_at_a_small_size(jobs):
    """scripts/torch_serve_1m_mesh.py's own check (shard ranks against one
    device on its int8 index), at 3,000 documents and two gloo ranks."""
    _, logs = jobs
    last = json.loads(logs["1m"].strip().splitlines()[-1])
    assert last["merge_1m"] == "ok" and last["ranks"] == 2
    assert last["backend"] == "gloo" and len(last["sharded_ms"]) == 2
