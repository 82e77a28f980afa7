"""The CLI's several-card flags on the CPU: `train --num-devices 2` and
`rank --n-shards 2` as subprocesses of `python -m aspire_tpu_torch ...
--device cpu` (gloo ranks), against the same commands on one rank.

The run directory of two data ranks holds what one process writes: the same
files, run_info.json equal, the same metrics lines with losses within 2e-4
and parameters within 5e-4 (tests/test_dp_parity.py's bounds).  Two pairs of
runs are held so: one with Adam and f32 activations, and one with the
default bf16 activations and Adagrad.  Adam turns a gradient that is zero up
to rounding (a key bias, the last LayerNorm's bias) into a whole step of
either sign; in bf16 such steps move the dev score by its own rounding
(1.2e-3 from Flax's initial weights), so the bf16 pair takes Adagrad, whose
initial accumulator keeps a step as small as its gradient.  The rankings
of two shard ranks equal one rank's: ids equal where the scores are apart,
scores within 1e-5 (the JAX package's sharded tests' bound), for the pool
protocol and for the global one with the OT rerank; an id may differ only
for an exact copy of its document, which ties with it in every score.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_cli import ENV, WORDS, run_cli

RANKED = "test-pid2pool-toy-otaspire-ranked.json"


def _start(args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m",
         "aspire_tpu_torch", *args], cwd=cwd, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(procs: dict) -> dict:
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stdout[-2000:], stderr[-4000:])
        out[name] = stdout
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ranks")
    rng = np.random.default_rng(7)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title"] + WORDS
    (root / "vocab").mkdir()
    (root / "vocab" / "vocab.txt").write_text("\n".join(vocab) + "\n")
    from test_cli import write_train_files
    from tests_evalds import make_eval_dataset
    write_train_files(root, rng)
    make_eval_dataset(root, rng, WORDS, n_queries=4)
    cfg = {"model_name": "miswordbienc", "score_aggregation": "l2wasserstein",
           "sent_sm_temp": 5000.0, "train_size": 24, "dev_size": 8,
           "batch_size": 4, "accumulated_batch_size": 8, "num_epochs": 1,
           "learning_rate": 1e-4, "num_warmup_steps": 2,
           "lr_decay_method": "warmuplin", "es_check_every": 4,
           "max_sents": 4, "update_rule": "adam", "decay_lr_every": 1,
           "base-pt-layer": str(root / "vocab")}
    (root / "cfg.json").write_text(json.dumps(cfg))
    (root / "cfg_adagrad.json").write_text(json.dumps({**cfg, "update_rule": "adagrad"}))
    common = ["--device", "cpu"]
    data = ["--train", str(root / "train.jsonl"), "--dev", str(root / "dev.jsonl"),
            "--tiny", "--seq-len", "32", *common]
    pairs = {"f32": ["--config", str(root / "cfg.json"), "--no-bf16-compute"],
             "bf16": ["--config", str(root / "cfg_adagrad.json")]}
    procs = {}
    for pair, extra in pairs.items():
        for n in (1, 2):
            procs[f"train{n}_{pair}"] = _start(
                ["train", *extra, *data, "--out", str(root / f"run{n}_{pair}"),
                 *(["--num-devices", "2"] if n == 2 else [])], root)
    out = _finish(procs)
    run_cli(["build-index", "--run-dir", str(root / "run1_f32"), "--tokenizer",
             str(root / "vocab"), "--corpus", str(root / "abstracts-toy.jsonl"),
             "--out", str(root / "idx"), "--batch-size", "8", "--n-shards", "2",
             *common], root)
    rank = ["rank", "--index", str(root / "idx"), "--dataset", "toy",
            "--dataset-dir", str(root), "--model", "otaspire", "--run-dir",
            str(root / "run1_f32"), "--tokenizer", str(root / "vocab"),
            "--rerank", "ot", "--ot-solver", "xla", "--no-dumps", *common]
    protocols = {"pool": [], "global": ["--protocol", "global", "--k", "5"]}
    procs = {}
    for proto, extra in protocols.items():
        for n in (1, 2):
            procs[f"{proto}{n}"] = _start(
                [*rank, *extra, "--out", str(root / f"{proto}{n}"),
                 "--n-shards", str(n)], root)
    out.update(_finish(procs))
    return root, out


def _same_training(root, pair):
    one, two = root / f"run1_{pair}", root / f"run2_{pair}"
    m1 = [json.loads(ln) for ln in (one / "metrics.jsonl").open()]
    m2 = [json.loads(ln) for ln in (two / "metrics.jsonl").open()]
    assert [m["kind"] for m in m1] == [m["kind"] for m in m2]
    for a, b in zip(m1, m2):
        key = "loss" if a["kind"] == "train_loss" else "score"
        np.testing.assert_allclose(b[key], a[key], rtol=2e-4, atol=2e-4)
    for name in ("model_final.pt", "model_cur_best.pt"):
        want = torch.load(one / name, weights_only=True)
        got = torch.load(two / name, weights_only=True)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=5e-4, atol=5e-4, err_msg=k)


def test_two_data_ranks_write_the_one_rank_run(runs):
    root, out = runs
    one, two = root / "run1_f32", root / "run2_f32"
    assert "on 2 data ranks (gloo)" in out["train2_f32"]
    assert sorted(p.name for p in one.iterdir()) == \
        sorted(p.name for p in two.iterdir())
    assert json.loads((one / "run_info.json").read_text()) == \
        json.loads((two / "run_info.json").read_text())
    _same_training(root, "f32")


def test_two_data_ranks_train_as_one_rank_in_bf16(runs):
    root, out = runs
    assert "on 2 data ranks (gloo)" in out["train2_bf16"]
    _same_training(root, "bf16")


@pytest.mark.parametrize("proto", ["pool", "global"])
def test_two_shard_ranks_rank_as_one_rank(runs, proto):
    root, out = runs
    want = json.loads((root / f"{proto}1" / RANKED).read_text())
    got = json.loads((root / f"{proto}2" / RANKED).read_text())
    assert got.keys() == want.keys()
    assert "ranked 4 queries" in out[f"{proto}2"]
    # the toy corpus holds each query three times (qN, qNc0, qNc1: the same
    # title and sentences), and such copies tie in every score: where k cuts
    # a group of copies, which of them is kept is the tie's order
    text = {}
    for line in (root / "abstracts-toy.jsonl").read_text().splitlines():
        paper = json.loads(line)
        text[paper["paper_id"]] = (paper["title"], paper["abstract"])
    for q in want:
        ws = np.array([s for _, s in want[q]])
        gs = np.array([s for _, s in got[q]])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
        apart = np.ones(len(ws), bool)
        gaps = np.abs(np.diff(ws)) > 1e-4
        apart[1:] &= gaps
        apart[:-1] &= gaps
        for (g, _), (w, _), a in zip(got[q], want[q], apart):
            if a and g != w:
                assert text[g] == text[w], (q, g, w)
    # only rank 0 wrote: one ranked file, nothing else of the other rank
    assert sorted(p.name for p in (root / f"{proto}2").iterdir()) == \
        sorted(p.name for p in (root / f"{proto}1").iterdir())
