"""`python -m aspire_tpu_torch` end to end on the CPU (`--device cpu
--tiny`), in subprocesses with PYTHONPATH set: train -> evaluate ->
build-index -> rank -> compare, with what the file contracts say both
packages share read back by the JAX package: run_info.json, the index files,
scores.json and the ranked pools, and the query-evaluations CSVs that
`compare` reads."""
import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
# one intra-op thread a subprocess: test workers share the machine's cores
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def run_cli(args, cwd, check=True):
    proc = subprocess.run([sys.executable, "-m", "aspire_tpu_torch", *args],
                          cwd=cwd, env=ENV, capture_output=True, text=True,
                          timeout=600)
    if check:
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def _json_tail(stdout: str):
    return json.loads(stdout[stdout.index("{"):])


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(42)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title"] + WORDS
    (root / "vocab").mkdir()
    (root / "vocab" / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (root / "vocab" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
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
    vocab_dir, run = str(root / "vocab"), str(root / "run")
    common = ["--device", "cpu"]
    out = {"root": root, "run": run, "vocab": vocab_dir}
    out["train"] = run_cli(["train", "--config", str(root / "cfg.json"),
                            "--train", str(root / "train.jsonl"),
                            "--dev", str(root / "dev.jsonl"), "--out", run,
                            "--tiny", "--seq-len", "32", "--fast-tokenizer",
                            *common], root)
    for name, solver in (("res_a", "xla"), ("res_b", "pallas")):
        out[name] = run_cli(["evaluate", "--dataset", "toy", "--dataset-dir",
                             str(root), "--model", "otaspire", "--run-dir", run,
                             "--tokenizer", vocab_dir, "--results",
                             str(root / name), "--ot-solver", solver,
                             "--batch-size", "4", *common], root)
    for name, extra in (("idx_f32", []), ("idx_int8", ["--int8"])):
        out[name] = run_cli(["build-index", "--run-dir", run, "--tokenizer",
                             vocab_dir, "--corpus", str(root / "abstracts-toy.jsonl"),
                             "--out", str(root / name), "--batch-size", "8",
                             *extra, *common], root)
    out["rank_pool"] = run_cli(
        ["rank", "--index", str(root / "idx_f32"), "--dataset", "toy",
         "--dataset-dir", str(root), "--model", "otaspire", "--run-dir", run,
         "--tokenizer", vocab_dir, "--out", str(root / "rank_pool"),
         "--rerank", "ot", "--ot-solver", "xla", "--dump-k", "3", *common], root)
    out["rank_global"] = run_cli(
        ["rank", "--index", str(root / "idx_int8"), "--dataset", "toy",
         "--dataset-dir", str(root), "--model", "otaspire", "--run-dir", run,
         "--tokenizer", vocab_dir, "--out", str(root / "rank_global"),
         "--protocol", "global", "--k", "5", "--rerank", "ot", "--no-dumps",
         *common], root)
    out["compare"] = run_cli(
        ["compare", "--results-a", str(root / "res_a" / "query-evaluations.csv"),
         "--results-b", str(root / "res_b" / "query-evaluations.csv")], root)
    return out


def test_train_writes_a_run_the_jax_package_reads(pipeline):
    from aspire_tpu.core.config import RunConfig as JRunConfig
    run = pathlib.Path(pipeline["run"])
    assert "trained 3 steps" in pipeline["train"].stdout
    for name in ("run_info.json", "model_cur_best.pt", "model_final.pt",
                 "metrics.jsonl"):
        assert (run / name).exists(), name
    rc = JRunConfig.from_run_info(run / "run_info.json")
    assert rc.model.model_name == "miswordbienc"
    assert rc.extra["bert_config"]["hidden_size"] == 32
    assert rc.extra["bert_config"]["vocab_size"] == 12
    kinds = [json.loads(ln)["kind"] for ln in (run / "metrics.jsonl").open()]
    assert "dev_score" in kinds and "train_loss" in kinds


def test_evaluate_outputs_match_the_jax_evaluation_of_its_scores(pipeline, tmp_path):
    """The JAX package's evaluate_scores over the port's scores.json gives
    the aggregates the port printed and the same CSVs."""
    from aspire_tpu.evaluation.datasets import EvalDataset as JDataset
    from aspire_tpu.evaluation.evaluate import evaluate_scores
    from test_torch_evaluation import assert_csv_equal
    root = pipeline["root"]
    out = _json_tail(pipeline["res_a"].stdout)
    assert set(out) == {"all"} and set(out["all"]) == {"dev", "test"}
    (tmp_path / "j").mkdir()
    (tmp_path / "j" / "scores.json").write_text(
        (root / "res_a" / "scores.json").read_text())
    want = evaluate_scores(str(tmp_path / "j"), JDataset("toy", str(root)))
    for split, metrics in want.items():
        for m, v in metrics.items():
            assert math.isclose(out["all"][split][m], v, rel_tol=1e-12), m
    for name in ("query-evaluations.csv", "aggregated-evaluations.csv"):
        assert_csv_equal(root / "res_a" / name, tmp_path / "j" / name)
    # the kernel route's name on the CPU runs K1's plain version
    a = json.loads((root / "res_a" / "scores.json").read_text())
    b = json.loads((root / "res_b" / "scores.json").read_text())
    for q in a:
        np.testing.assert_allclose([s for _, s in b[q]], [s for _, s in a[q]],
                                   atol=1e-3, rtol=1e-3)


def test_index_files_load_in_the_jax_package(pipeline):
    from aspire_tpu.index.dense import DenseBucketIndex as JIndex
    from aspire_tpu_torch.index.dense import DenseBucketIndex
    root = pipeline["root"]
    n_docs = sum(1 for _ in open(root / "abstracts-toy.jsonl"))
    for name, dtype in (("idx_f32", "float32"), ("idx_int8", "int8")):
        assert f"indexed {n_docs} docs" in pipeline[name].stdout
        j, t = JIndex.load(str(root / name)), DenseBucketIndex.load(root / name)
        assert j.pids == t.pids and len(j.pids) == n_docs
        assert t.is_int8 == (dtype == "int8") == j.is_int8
        for bj, bt in zip(j.buckets, t.buckets):
            np.testing.assert_array_equal(np.asarray(bj["sents"]), bt["sents"])
            np.testing.assert_array_equal(np.asarray(bj["doc_idx"]), bt["doc_idx"])


def test_ranked_pools_evaluate_in_both_packages(pipeline):
    from aspire_tpu.evaluation.ranking_eval import eval_pool_ranking as j_eval
    from aspire_tpu_torch.evaluation.ranking_eval import eval_pool_ranking
    root = pipeline["root"]
    out = str(root / "rank_pool")
    ranked = json.loads(pathlib.Path(out, "test-pid2pool-toy-otaspire-ranked.json")
                        .read_text())
    pool = json.loads((root / "test-pid2anns-toy.json").read_text())
    assert set(ranked) == set(pool)
    for q, rows in ranked.items():
        assert sorted(c for c, _ in rows) == sorted(pool[q]["cands"])
        scores = [s for _, s in rows]
        assert scores == sorted(scores, reverse=True)
    got = eval_pool_ranking(out, "toy", "otaspire", dataset_dir=str(root))
    assert got == j_eval(out, "toy", "otaspire", dataset_dir=str(root))
    # the pool protocol's OT scores are the evaluation's (scores.json holds
    # the negated similarity), candidate by candidate -- but for the copies of
    # the query, whose distance 0 the Gram expansion rounds differently in
    # the two batch layouts (~1e-3)
    scores = json.loads((root / "res_a" / "scores.json").read_text())
    papers = {}
    for line in open(root / "abstracts-toy.jsonl"):
        d = json.loads(line)
        papers[d["paper_id"]] = d["abstract"]
    for q, rows in ranked.items():
        want = {c: -s for c, s in scores[q]}
        others = [(c, s) for c, s in rows if papers[c] != papers[q]]
        assert len(others) == len(rows) - 2
        np.testing.assert_allclose([s for _, s in others],
                                   [want[c] for c, _ in others],
                                   atol=1e-4, rtol=1e-4)
    dumps = sorted(p.name for p in (root / "rank_pool" / "neighbours").iterdir())
    assert dumps == sorted(f"{q}-neighbours.txt" for q in pool)
    glob = json.loads((root / "rank_global" / "test-pid2pool-toy-otaspire-ranked.json")
                      .read_text())
    assert set(glob) == set(pool) and all(len(v) == 5 for v in glob.values())
    assert not (root / "rank_global" / "neighbours").exists()


def test_compare_matches_the_jax_cli(pipeline):
    from aspire_tpu.cli import cmd_compare
    root = pipeline["root"]
    args = SimpleNamespace(results_a=str(root / "res_a" / "query-evaluations.csv"),
                           results_b=str(root / "res_b" / "query-evaluations.csv"),
                           metric="av_precision", n_comparisons=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cmd_compare(args)
    got = json.loads(pipeline["compare"].stdout)
    want = json.loads(buf.getvalue())
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k])
        else:
            assert got[k] == v, k


def test_compare_reads_what_pandas_reads(tmp_path, rng):
    """Two methods' per-query CSVs that differ: the port's compare (csv
    module) prints what the JAX CLI's (pandas) prints."""
    import pandas as pd
    from aspire_tpu.cli import cmd_compare
    from aspire_tpu_torch.cli import main
    for name in ("a", "b"):
        pd.DataFrame([{"paper_id": f"{i}", "av_precision": float(rng.random()),
                       "ndcg": float(rng.random())} for i in range(12)]
                     ).to_csv(tmp_path / f"{name}.csv", index=False)
    argv = {"results_a": str(tmp_path / "a.csv"),
            "results_b": str(tmp_path / "b.csv"), "metric": "ndcg",
            "n_comparisons": 2}
    bufs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(bufs[0]):
        cmd_compare(SimpleNamespace(**argv))
    with contextlib.redirect_stdout(bufs[1]):
        main(["compare", "--results-a", argv["results_a"], "--results-b",
              argv["results_b"], "--metric", "ndcg", "--n-comparisons", "2"])
    assert json.loads(bufs[1].getvalue()) == json.loads(bufs[0].getvalue())


def test_cuda_is_the_default_device(tmp_path):
    """Without CUDA a subcommand raises unless --device cpu is given."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = run_cli(["build-index", "--corpus", "nothing.jsonl", "--out",
                    str(tmp_path / "i"), "--weights-dir", str(tmp_path)],
                   tmp_path, check=False)
    assert proc.returncode != 0
    assert "device='cuda'" in proc.stderr and "is_available() is False" in proc.stderr


@pytest.mark.parametrize("argv", [
    ["train", "--num-processes", "2"],
    ["train", "--coordinator", "localhost:1234"],
    ["train", "--num-devices", "0"],
    ["train", "--fast-rng"],
    ["build-index", "--n-shards", "0"],
    ["rank", "--n-shards", "0"],
    ["rank", "--process-id", "1"],
])
def test_jax_only_flags_are_refused(argv, tmp_path):
    """--fast-rng stays refused; the several-card flags run ranks
    (test_torch_cli_ranks.py) and are refused where they cannot mean what
    they say: a machine count without the coordinator, a coordinator or
    process id without several machines, no ranks at all."""
    from aspire_tpu_torch.cli import main
    required = {"train": ["--config", "c", "--train", "t", "--out", str(tmp_path)],
                "build-index": ["--corpus", "c", "--out", str(tmp_path)],
                "rank": ["--index", "i", "--dataset", "d", "--dataset-dir", "d",
                         "--model", "m", "--out", str(tmp_path)]}[argv[0]]
    with pytest.raises(SystemExit, match="dropped|at least 1|need"):
        main(argv + required + ["--device", "cpu"])


def test_preprocess_and_ner_are_not_registered():
    """Every subcommand of the JAX parser is registered, preprocess and ner
    among them (their flags: tests/test_torch_cli_preprocess.py)."""
    from aspire_tpu_torch.cli import build_parser
    sub = next(a for a in build_parser()._actions
               if getattr(a, "choices", None) and "train" in a.choices)
    assert set(sub.choices) == {"train", "evaluate", "build-index", "rank",
                                "compare", "preprocess", "ner"}
