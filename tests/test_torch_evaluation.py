"""Evaluation (evaluation/*): the port against the JAX package on the same
files and weights.

  * metrics, protocols, datasets and ranking_eval: equal values;
  * run_evaluation for the ot, l2max and cosine_max aggregations on a dataset
    with a split file, the faceted CSFCube protocol (the real fold query ids)
    and the NER variant: scores*.json with the same candidates in the same
    order and scores within 1e-4 (JAX "xla" against the port's "torch"),
    and the CSVs equal as parsed values;
  * the model zoo (get_model over the port's run directories, the HF
    directory families) encoding like the JAX models built from the same
    weights within 1e-4, and pair_report.

The port tokenizes with its own FastWordPiece, the JAX package with HF's
BertTokenizer (the same ids on ASCII text).  No document is scored against
an identical one: at distance 0 the Gram expansion's cancellation rounds
differently in the two packages (~1e-3)."""
import csv
import io
import json
import math

import jax
import numpy as np
import pytest
import torch
from transformers import BertTokenizer

from aspire_tpu.evaluation import datasets as jds
from aspire_tpu.evaluation import evaluate as jeval
from aspire_tpu.evaluation import metrics as jmetrics
from aspire_tpu.evaluation import models as jmodels
from aspire_tpu.evaluation import protocols as jproto
from aspire_tpu.evaluation import ranking_eval as jrank
from aspire_tpu.models.bert import BertConfig as JConfig
from aspire_tpu.models.bert import BertModel as JBert
from aspire_tpu.models.encoders import BiEncoder as JBiEncoder
from aspire_tpu.models.encoders import ConSentEncoder as JEncoder
from aspire_tpu_torch.core.config import RunConfig
from aspire_tpu_torch.core.types import MultiVec
from aspire_tpu_torch.evaluation import datasets as tds
from aspire_tpu_torch.evaluation import evaluate as teval
from aspire_tpu_torch.evaluation import metrics as tmetrics
from aspire_tpu_torch.evaluation import models as tmodels
from aspire_tpu_torch.evaluation import protocols as tproto
from aspire_tpu_torch.evaluation import ranking_eval as trank
from aspire_tpu_torch.models.bert import BertConfig
from aspire_tpu_torch.models.convert import state_dict_from_flax_params
from aspire_tpu_torch.text.fast import FastWordPiece

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", "x", "q"] + WORDS
LABELS = ["background_label", "objective_label", "method_label", "result_label"]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the machine's cores: torch's intra-op pool at its
    default size oversubscribes them, and this file's many small ops then
    run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ev")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return d


@pytest.fixture(scope="module")
def toks(vocab_dir):
    f = str(vocab_dir / "vocab.txt")
    return FastWordPiece(f), BertTokenizer(f, do_lower_case=True)


def _noisy(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + 0.05 * r.standard_normal(x.shape).astype(np.float32),
                        tree)


@pytest.fixture(scope="module")
def weights():
    """A tiny ConSentEncoder's Flax tree (noise on every weight) and the
    port's state_dict of the same numbers."""
    cfg = JConfig.tiny(vocab_size=len(VOCAB))
    tree = JEncoder(cfg, max_sents=6).init(
        jax.random.key(0), *(np.zeros((1, 8), np.int32),) * 3)["params"]
    tree = _noisy(tree, 1)
    return tree, state_dict_from_flax_params(tree)


def _sents(rng, n):
    return [" ".join(rng.choice(WORDS, int(rng.integers(3, 7)))) for _ in range(n)]


def make_dataset(root, rng, name="toy", qpids=None, facets=(None,),
                 n_cands=9, ner=False):
    """Queries with near-copy relevant candidates (a sentence replaced) and
    random distractors; CSFCube's layout (pred_labels, one pool file a
    facet) when facets are given; entities in {name}-ner.jsonl with `ner`."""
    qpids = qpids or [f"q{i}" for i in range(4)]
    papers, anns = {}, {f: {} for f in facets}
    for facet in facets:
        for qpid in qpids:
            if qpid not in papers:
                n = int(rng.integers(3, 6))
                papers[qpid] = {"title": "title q", "abstract": _sents(rng, n),
                                "pred_labels": list(rng.choice(LABELS, n))}
            q = papers[qpid]
            cands, rels = [], []
            for ci in range(n_cands):
                cpid = f"{qpid}{(facet or 'u')[0]}c{ci}"
                if ci < 3:
                    abstract = list(q["abstract"])
                    abstract[ci % len(abstract)] = _sents(rng, 1)[0]
                    papers[cpid] = {"title": "title q", "abstract": abstract,
                                    "pred_labels": q["pred_labels"]}
                    rels.append(int(rng.integers(1, 4)))
                else:
                    n = int(rng.integers(1, 5))
                    papers[cpid] = {"title": "title x",
                                    "abstract": _sents(rng, n),
                                    "pred_labels": list(rng.choice(LABELS, n))}
                    rels.append(0)
                cands.append(cpid)
            anns[facet][qpid] = {"cands": cands, "relevance_adju": rels}
    with open(root / f"abstracts-{name}.jsonl", "w") as f:
        for pid, p in papers.items():
            f.write(json.dumps({"paper_id": pid, **p}) + "\n")
    for facet in facets:
        suffix = f"-{facet}" if facet else ""
        with open(root / f"test-pid2anns-{name}{suffix}.json", "w") as f:
            json.dump(anns[facet], f)
    if facets == (None,):
        with open(root / f"{name}-evaluation_splits.json", "w") as f:
            json.dump({"dev": qpids[:2], "test": qpids[2:]}, f)
    if ner:
        ents = {pid: [list(rng.choice(WORDS, int(rng.integers(0, 3))))
                      for _ in p["abstract"]] for pid, p in papers.items()}
        with open(root / f"{name}-ner.jsonl", "w") as f:
            json.dump(ents, f)
    with open(root / f"{name}-queries-release.csv", "w") as f:
        f.write("pid,title,facet\n")
        for i, qpid in enumerate(qpids):
            f.write(f"{qpid},paper {i},{facets[0] or 'all'}\n")
    return papers, anns


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = []
    for r in rows:
        parsed = {}
        for k, v in r.items():
            try:
                parsed[k] = float(v)
            except ValueError:
                parsed[k] = v
        out.append(parsed)
    return out


def assert_csv_equal(got_path, want_path):
    got, want = _read_csv(got_path), _read_csv(want_path)
    with open(got_path) as g, open(want_path) as w:
        assert g.readline() == w.readline()           # same columns, order
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                assert math.isclose(g[k], w[k], rel_tol=1e-12, abs_tol=1e-12), \
                    (k, g[k], w[k])
            else:
                assert g[k] == w[k], (k, g[k], w[k])


def assert_scores_equal(got_path, want_path):
    with open(got_path) as f:
        got = json.load(f)
    with open(want_path) as f:
        want = json.load(f)
    assert list(got) == list(want)
    for q in want:
        assert [c for c, _ in got[q]] == [c for c, _ in want[q]], q
        np.testing.assert_allclose([s for _, s in got[q]],
                                   [s for _, s in want[q]], atol=TOL, rtol=TOL)


# ------------------------------------------------------------ host modules
def test_metrics_equal(rng):
    for _ in range(40):
        n = int(rng.integers(1, 40))
        r = list(rng.integers(0, 4, n) * (rng.random(n) < 0.4))
        assert tmetrics.compute_metrics(r) == jmetrics.compute_metrics(r)
        assert tmetrics.compute_metrics(r, threshold_grade=1) == \
            jmetrics.compute_metrics(r, threshold_grade=1)
        for k in (1, min(3, n), n):
            assert tmetrics.ndcg_at_k(r, k, 1) == jmetrics.ndcg_at_k(r, k, 1)
            assert tmetrics.precision_at_k(r, k) == jmetrics.precision_at_k(r, k)
        assert tmetrics.r_precision(r) == jmetrics.r_precision(r)
    with pytest.raises(ValueError):
        tmetrics.precision_at_k([1], 0)


def test_protocols_equal(rng):
    folds = tproto.load_csfcube_folds()
    assert folds == jproto.load_csfcube_folds()
    qm = {q.rsplit("_", 1)[0]: tmetrics.compute_metrics(
        list(rng.integers(0, 4, 12))) for q in folds["method"]["fold1_dev"]
        + folds["method"]["fold1_test"]}
    keyed = {f"{q}_method": m for q, m in qm.items()}
    for split in ("dev", "test"):
        assert tproto.aggregate_crossval(keyed, "method", split) == \
            jproto.aggregate_crossval(keyed, "method", split)
    assert tproto.aggregate_split(qm) == jproto.aggregate_split(qm)
    a = {f"q{i}": {"av_precision": float(rng.random())} for i in range(9)}
    b = {f"q{i}": {"av_precision": float(rng.random())} for i in range(9)}
    assert tproto.significance_test(a, b, n_comparisons=3) == \
        jproto.significance_test(a, b, n_comparisons=3)
    scores = {"q": {"a": 0.5, "b": 0.9, "c": 0.1}}
    assert tproto.rank_candidates(scores) == jproto.rank_candidates(scores)
    ranked = {"q": [("b", 1.0), ("z", 0.5)]}
    gold = {"q": {"a": 2, "b": 1, "c": 0}}
    with pytest.raises(tproto.PoolMismatchError, match="'z'"):
        tproto.ranked_relevances(ranked, gold)
    assert tproto.ranked_relevances(ranked, gold, on_missing="intersect") == \
        jproto.ranked_relevances(ranked, gold, on_missing="intersect")


def test_dataset_loaders_equal(tmp_path, rng):
    make_dataset(tmp_path, rng, ner=True)
    got, want = tds.EvalDataset("toy", str(tmp_path)), \
        jds.EvalDataset("toy", str(tmp_path))
    assert got.dataset == want.dataset and got.ner_data == want.ner_data
    assert list(got) == list(want)
    pid = next(iter(want.dataset))
    assert got.get(pid) == want.get(pid)
    assert got.get_test_pool() == want.get_test_pool()
    assert got.get_gold_test_data() == want.get_gold_test_data()
    assert got.get_test_dev_split() == want.get_test_dev_split()
    assert got.get_threshold_grade() == want.get_threshold_grade()
    md_t, md_j = got.get_query_metadata(), want.get_query_metadata()
    assert list(md_t) == list(md_j.index)
    for pid, row in md_t.items():
        assert row == {k: str(v) for k, v in md_j.loc[pid].to_dict().items()}


def test_write_csv_is_pandas_to_csv(tmp_path):
    import pandas as pd
    rows = [{"paper_id": "a1", "x": 0.1 + 0.2, "y": 1 / 3, "z": float("nan")},
            {"paper_id": "b,2", "x": 1e-17, "y": 2.0, "z": 5.5}]
    teval.write_csv(str(tmp_path / "t.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "p.csv", index=False)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()


def test_pool_ranking_eval_equal(tmp_path, rng):
    make_dataset(tmp_path, rng)
    pool = jds.EvalDataset("toy", str(tmp_path)).get_test_pool()
    ranked = {q: [[c, float(rng.random())] for c in v["cands"]]
              for q, v in pool.items()}
    with open(jrank.ranked_pool_filename(str(tmp_path), "toy", "m"), "w") as f:
        json.dump(ranked, f)
    assert trank.eval_pool_ranking(str(tmp_path), "toy", "m") == \
        jrank.eval_pool_ranking(str(tmp_path), "toy", "m")
    trank.print_pool_neighbours(tds.EvalDataset("toy", str(tmp_path)), ranked,
                                str(tmp_path / "nt"), top_k=4)
    jrank.print_pool_neighbours(jds.EvalDataset("toy", str(tmp_path)), ranked,
                                str(tmp_path / "nj"), top_k=4)
    for p in (tmp_path / "nj").iterdir():
        assert (tmp_path / "nt" / p.name).read_text() == p.read_text()


# -------------------------------------------------------------- pipelines
def _pair(toks, weights, cls_t=tmodels.AspireSimilarityModel,
          cls_j=jmodels.AspireSimilarityModel, **kw):
    fast, hf = toks
    tree, sd = weights
    port = cls_t(name="m", bert_config=BertConfig.tiny(vocab_size=len(VOCAB)),
                 state_dict=sd, tokenizer=fast, device="cpu", **kw)
    jax_ = cls_j(name="m", bert_config=JConfig.tiny(vocab_size=len(VOCAB)),
                 params=tree, tokenizer=hf, **kw)
    return port, jax_


def _run_both(tmp_path, port, jax_, name, **kw):
    out_t = teval.run_evaluation(port, tds.EvalDataset(name, str(tmp_path)),
                                 str(tmp_path / "rt"), **kw)
    out_j = jeval.run_evaluation(jax_, jds.EvalDataset(name, str(tmp_path)),
                                 str(tmp_path / "rj"), **kw)
    assert set(out_t) == set(out_j)
    for key in out_j:
        for split in out_j[key]:
            for m, v in out_j[key][split].items():
                assert math.isclose(out_t[key][split][m], v, rel_tol=1e-12,
                                    abs_tol=1e-12), (key, split, m)
    for p in sorted((tmp_path / "rj").iterdir()):
        if p.suffix == ".json":
            assert_scores_equal(tmp_path / "rt" / p.name, p)
        else:
            assert_csv_equal(tmp_path / "rt" / p.name, p)
    return out_t


@pytest.mark.parametrize("agg", ["ot", "l2max", "cosine_max"])
def test_run_evaluation_matches(tmp_path, rng, toks, weights, agg):
    make_dataset(tmp_path, rng)
    port, jax_ = _pair(toks, weights, agg=agg, max_sents=6, ot_temp=5000.0)
    assert port.ot_solver == "torch"              # 'xla' -> the plain loop
    out = _run_both(tmp_path, port, jax_, "toy")
    assert set(out) == {"all"} and set(out["all"]) == {"dev", "test"}
    assert sorted(p.name for p in (tmp_path / "rt").iterdir()) == [
        "aggregated-evaluations.csv", "query-evaluations.csv", "scores.json"]


def test_csfcube_faceted_protocol_matches(tmp_path, rng, toks, weights):
    folds = tproto.load_csfcube_folds()
    qpids = sorted({q.rsplit("_", 1)[0] for f in ("background", "method", "result")
                    for fold in folds[f].values() for q in fold})
    make_dataset(tmp_path, rng, name="csfcube", qpids=qpids,
                 facets=("background", "method", "result"), n_cands=6)
    port, jax_ = _pair(toks, weights, agg="ot", max_sents=6, ot_temp=5000.0)
    out = _run_both(tmp_path, port, jax_, "csfcube")
    assert set(out) == {"background", "method", "result", "all"}
    with pytest.raises(ValueError, match="per facet"):
        teval.run_evaluation(port, tds.EvalDataset("csfcube", str(tmp_path)),
                             str(tmp_path / "x"), facets=[None])


@pytest.mark.parametrize("kind", ["ner", "context_ner"])
def test_ner_variants_match(tmp_path, rng, toks, weights, kind):
    make_dataset(tmp_path, rng, ner=True)
    cls_t, cls_j = {
        "ner": (tmodels.AspireNERSimilarityModel, jmodels.AspireNERSimilarityModel),
        "context_ner": (tmodels.AspireContextNERSimilarityModel,
                        jmodels.AspireContextNERSimilarityModel)}[kind]
    port, jax_ = _pair(toks, weights, cls_t, cls_j, agg="ot", max_sents=6,
                       ot_temp=5000.0)
    assert port.encoding_type == "sentence-entity"
    _run_both(tmp_path, port, jax_, "toy", cache_path=str(tmp_path / "c.h5"))
    ds = tds.EvalDataset("toy", str(tmp_path))
    papers = [ds.get(p) for p, _ in list(ds)[:3]]
    for (xi, sc), (xj, scj) in zip(port.encode_quantized(papers),
                                   jax_.encode_quantized(papers)):
        assert xi.dtype == np.int8 and xi.shape == xj.shape
        assert np.abs(xi.astype(int) - xj.astype(int)).max() <= 1
        np.testing.assert_allclose(sc, scj, rtol=TOL)


def test_encode_quantized_and_seq_buckets(rng, toks, weights):
    port, jax_ = _pair(toks, weights, agg="l2max", max_sents=6)
    papers = [{"TITLE": "title", "ABSTRACT": _sents(rng, int(rng.integers(1, 8)))}
              for _ in range(5)]
    for (xi, sc), (xj, scj) in zip(port.encode_quantized(papers),
                                   jax_.encode_quantized(papers)):
        assert np.abs(xi.astype(int) - xj.astype(int)).max() <= 1
        np.testing.assert_allclose(sc, scj, rtol=TOL)
    bucketed, _ = _pair(toks, weights, agg="l2max", max_sents=6,
                        seq_buckets=(16, 32, 64))
    for a, b in zip(bucketed.encode(papers), port.encode(papers)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_score_ladder_pads_and_grows_the_sentence_bucket(rng, toks, weights):
    """A pool past the first rung, and documents longer than max_sents
    (the bucket grows in steps of 8): the same scores as the JAX ladder."""
    port, jax_ = _pair(toks, weights, agg="ot", max_sents=4, ot_temp=5000.0)
    d = 32
    q = rng.normal(size=(3, d)).astype(np.float32)
    cands = [rng.normal(size=(int(rng.integers(1, 11)), d)).astype(np.float32)
             for _ in range(70)]
    got = port.get_similarities(q, cands)
    np.testing.assert_allclose(got, jax_.get_similarities(q, cands),
                               atol=TOL, rtol=TOL)
    assert got.shape == (70,)
    assert port.get_similarities(q, []).shape == (0,)
    np.testing.assert_allclose(port.get_similarity(q, cands[3]), got[3],
                               atol=TOL, rtol=TOL)


def test_faceted_encoding_filter(toks, weights):
    port, jax_ = _pair(toks, weights, agg="l2max", max_sents=6)
    enc = np.arange(24, dtype=np.float32).reshape(8, 3)
    data = {"FACETS": ["background_label", "objective_label", "method_label",
                       "result_label"],
            "ENTITIES": [["e1"], [], ["e2", "e3"], ["e4"]]}
    for facet in ("background", "method", "result"):
        np.testing.assert_array_equal(
            port.get_faceted_encoding(enc[:4], facet, data),
            jax_.get_faceted_encoding(enc[:4], facet, data))
    port.encoding_type = jax_.encoding_type = "sentence-entity"
    np.testing.assert_array_equal(port.get_faceted_encoding(enc, "method", data),
                                  jax_.get_faceted_encoding(enc, "method", data))


# ------------------------------------------------------------- model zoo
def _write_run(run_dir, model_name, state_dict, max_sents=6):
    """A run directory as the port's Trainer writes it."""
    run_dir.mkdir()
    rc = RunConfig.from_dict({"model_name": model_name, "max_sents": max_sents,
                              "score_aggregation": "l2wasserstein",
                              "sent_sm_temp": 5000.0})
    rc.extra["bert_config"] = dict(vars(BertConfig.tiny(vocab_size=len(VOCAB))))
    rc.to_run_info(run_dir / "run_info.json")
    torch.save(state_dict, run_dir / "model_cur_best.pt")


@pytest.mark.parametrize("model_name", ["otaspire", "cospecter", "cosentbert",
                                        "ictsentbert"])
def test_get_model_reads_port_runs(tmp_path, rng, toks, model_name):
    fast, hf = toks
    cfg = JConfig.tiny(vocab_size=len(VOCAB))
    zeros = (np.zeros((1, 8), np.int32),) * 3
    if model_name == "otaspire":
        tree = _noisy(JEncoder(cfg, max_sents=6).init(
            jax.random.key(1), *zeros)["params"], 2)
        sd = state_dict_from_flax_params(tree, prefix="encoder.")
        want = jmodels.AspireSimilarityModel(
            "m", cfg, tree, hf, agg="ot", max_sents=6, ot_temp=5000.0)
    elif model_name == "cospecter":
        tree = _noisy(JBiEncoder(cfg).init(jax.random.key(1),
                                           *zeros[:2])["params"], 2)
        sd = state_dict_from_flax_params(tree, prefix="encoder.")
        want = jmodels.ClsSimilarityModel(
            "m", cfg, tree["bert"], hf, layer_mix=np.asarray(tree["layer_weights"]))
    else:
        tree = _noisy(JBert(cfg).init(jax.random.key(1), *zeros[:2])["params"], 2)
        prefix = "sent_encoder." if model_name == "ictsentbert" else "encoder."
        sd = state_dict_from_flax_params(tree, prefix=prefix)
        want = jmodels.TrainedSentSimilarityModel("m", cfg, tree, hf)
    _write_run(tmp_path / "run", model_name, sd)
    got = tmodels.get_model(model_name, trained_model_path=str(tmp_path / "run"),
                            tokenizer=fast, device="cpu")
    papers = [{"TITLE": "title", "ABSTRACT": _sents(rng, int(rng.integers(1, 5)))}
              for _ in range(4)]
    for g, w in zip(got.encode(papers), want.encode(papers)):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL)
    if model_name == "otaspire":
        assert (got.agg, got.ot_temp, got.max_sents) == ("ot", 5000.0, 6)


def test_get_model_refuses_orbax_runs_and_unknown_names(tmp_path, toks):
    (tmp_path / "run").mkdir()
    RunConfig.from_dict({"model_name": "miswordbienc"}).to_run_info(
        tmp_path / "run" / "run_info.json")
    (tmp_path / "run" / "model_cur_best").mkdir()        # an orbax tree
    with pytest.raises(FileNotFoundError, match="orbax"):
        tmodels.get_model("otaspire", trained_model_path=str(tmp_path / "run"),
                          tokenizer=toks[0], device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        tmodels.get_model("nope", device="cpu")


def test_ot_solver_names():
    assert tmodels.resolve_ot_solver("xla", "cpu") == "torch"
    assert tmodels.resolve_ot_solver("pallas", "cpu") == "kernel"
    assert tmodels.resolve_ot_solver("auto", "cpu") == "torch"
    assert tmodels.resolve_ot_solver("auto", "cuda") == "kernel"
    with pytest.raises(ValueError, match="unknown OT solver"):
        tmodels.resolve_ot_solver("kernel_loop", "cpu")


@pytest.mark.parametrize("model_name", ["specter", "specter_ner", "sbtinybertsota",
                                        "aspire_compsci"])
def test_hf_dir_families_match_jax(tmp_path, rng, model_name):
    from test_torch_hf_dir import write_hf_dir
    write_hf_dir(tmp_path / "hf", "bin", seed=7)
    got = tmodels.get_model(model_name, weights_dir=str(tmp_path / "hf"),
                            device="cpu")
    want = jmodels.get_model(model_name, weights_dir=str(tmp_path / "hf"))
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
    papers = [{"TITLE": "title " + str(rng.choice(words)),
               "ABSTRACT": [" ".join(rng.choice(words, 4)) + "."
                            for _ in range(int(rng.integers(1, 4)))],
               "ENTITIES": [[str(rng.choice(words))]] * 3} for _ in range(3)]
    for g, w in zip(got.encode(papers), want.encode(papers)):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL)


def test_pair_report_matches(rng):
    from aspire_tpu.core.types import MultiVec as JMV
    from aspire_tpu.evaluation.diagnostics import pair_report as j_report
    from aspire_tpu_torch.evaluation.diagnostics import pair_report
    q = np.zeros((1, 6, 16), np.float32)
    c = np.zeros((1, 6, 16), np.float32)
    q[0, :4] = rng.normal(size=(4, 16))
    c[0, :5] = rng.normal(size=(5, 16))
    ql, cl = np.array([4], np.int32), np.array([5], np.int32)
    sents_q = [f"q{i}" for i in range(4)]
    sents_c = [f"c{i}" for i in range(5)]
    out_t, out_j = io.StringIO(), io.StringIO()
    got = pair_report(MultiVec(embed=torch.from_numpy(q), lens=torch.from_numpy(ql)),
                      MultiVec(embed=torch.from_numpy(c), lens=torch.from_numpy(cl)),
                      sents_q, sents_c, out=out_t)
    want = j_report(JMV(embed=q, lens=ql), JMV(embed=c, lens=cl), sents_q,
                    sents_c, out=out_j)
    for k in ("l2max", "ot"):
        assert math.isclose(got[k], want[k], rel_tol=TOL, abs_tol=TOL)
    for k in ("sims", "plan"):
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL)
    assert out_t.getvalue().splitlines()[-6:] == out_j.getvalue().splitlines()[-6:]
