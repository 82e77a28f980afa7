"""`python -m aspire_tpu_torch preprocess` and `ner` against the JAX package's
pipelines on the same inputs (made from a numpy seed): files written equal
byte for byte (pickles: equal once unpickled), the printed counts equal.
Subprocesses run with PYTHONPATH set to the repo root; the in-process cases
call aspire_tpu_torch.cli.main.  The host-only actions need no card even at
the default --device cuda; an action given an aligner encodes on --device."""
import json
import os
import pathlib
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aspire_tpu.data import corpus as jcorpus
from aspire_tpu.data import ner as jner
from aspire_tpu.data import preprocess as jpp
from aspire_tpu_torch import cli

from test_torch_align import runs  # noqa: F401  (fixture: cosentbert runs)
from test_torch_gorc_corpus import same_files, write_corpus
from test_torch_preprocess import corpus, write_treccovid

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
LIMITS = {"train_size": 100, "dev_size": 100}


def run_cli(args, cwd, check=True):
    proc = subprocess.run([sys.executable, "-m", "aspire_tpu_torch", *args],
                          cwd=cwd, env=ENV, capture_output=True, text=True,
                          timeout=600)
    if check:
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def last_json(stdout: str):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def batch_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("clipp") / "corpus"
    write_corpus(root, seed=31)
    return root


def test_gorc_subprocess_needs_no_card(batch_dir, tmp_path):
    """The default --device cuda: the host-only pipeline runs all the same."""
    proc = run_cli(["preprocess", "gorc", "--in-path", str(batch_dir),
                    "--out-path", str(tmp_path / "t"),
                    "--extra", json.dumps({"processes": 1, **LIMITS})], tmp_path)
    want = jcorpus.run_gorc_pipeline(str(batch_dir), str(tmp_path / "j"),
                                     processes=1, **LIMITS)
    assert last_json(proc.stdout) == want
    same_files(tmp_path / "t", tmp_path / "j")


def test_regen_examples_with_the_aligner(batch_dir, runs, tmp_path):  # noqa: F811
    """regen-examples with a trained cosentbert as the aligner, on the CPU,
    against the JAX package with the same weights; without --device cpu it
    needs CUDA."""
    from aspire_tpu.data import align as jalign
    vocab, jrun, trun = runs
    jcorpus.run_gorc_pipeline(str(batch_dir), str(tmp_path / "partials"),
                              processes=1, **LIMITS)
    extra = {"aligner_run_dir": trun, "aligner_tokenizer": vocab, **LIMITS}
    argv = ["preprocess", "regen-examples", "--in-path", str(tmp_path / "partials"),
            "--out-path", str(tmp_path / "t"), "--extra", json.dumps(extra)]
    proc = run_cli(argv + ["--device", "cpu"], tmp_path)
    embed = jalign.trained_sent_aligner(jrun, vocab)
    want = jcorpus.regenerate_examples(
        str(tmp_path / "partials"), str(tmp_path / "j"), aligner=embed, **LIMITS)
    assert last_json(proc.stdout) == want
    for name in ("train-coppsent.jsonl", "dev-coppsent.jsonl"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    compared = 0
    for split in ("train", "dev"):
        compared += same_aligned_examples(
            tmp_path / "t" / f"{split}-cocitabsalign.jsonl",
            tmp_path / "j" / f"{split}-cocitabsalign.jsonl", embed)
    assert compared > 0
    if not torch.cuda.is_available():
        proc = run_cli(argv, tmp_path, check=False)
        assert proc.returncode != 0 and "device='cuda'" in proc.stderr


def lead(m: np.ndarray) -> float:
    """How far the largest entry leads the next."""
    flat = np.sort(m.reshape(-1))
    return float(flat[-1] - flat[-2]) if flat.size > 1 else np.inf


def same_aligned_examples(path_t, path_j, embed, margin=1e-4) -> int:
    """Example files equal but for the positives' alignments, which are
    equal wherever their argmax leads the runner-up by more than `margin`
    (the corpus's citing contexts differ by a word or two, and a random
    encoder's cosines of such sentences tie to within the 1e-6 that the two
    packages' embeddings differ by).  Returns the alignments compared."""
    lines_t = path_t.read_text().splitlines()
    lines_j = path_j.read_text().splitlines()
    assert len(lines_t) == len(lines_j)
    compared = 0
    for et, ej in zip(map(json.loads, lines_t), map(json.loads, lines_j)):
        pos_t, pos_j = et["pos_context"], ej["pos_context"]
        q, p, c = (np.asarray(embed(s)) for s in (
            ej["query"]["ABSTRACT"], pos_j["ABSTRACT"], ej["citing_contexts"]))
        leads = (lead(q @ c.T), lead(p @ c.T), lead(q @ p.T))
        pairs = ((pos_t["cc_align"][0], pos_j["cc_align"][0]),
                 (pos_t["cc_align"][1], pos_j["cc_align"][1]),
                 (pos_t["abs_align"], pos_j["abs_align"]))
        for (a, b), gap in zip(pairs, leads):
            if gap > margin:
                assert a == b
                compared += 1
        for side in (pos_t, pos_j):
            del side["cc_align"], side["abs_align"]
        assert et == ej
    return compared


def jax_main(action, in_path, out_path, extra=None):
    jpp.main(SimpleNamespace(action=action, in_path=str(in_path),
                             out_path=str(out_path),
                             extra=json.dumps(extra) if extra else None))


def port_main(action, in_path, out_path, extra=None):
    argv = ["preprocess", action, "--in-path", str(in_path), "--out-path",
            str(out_path)] + (["--extra", json.dumps(extra)] if extra else [])
    return cli.main(argv)


@pytest.mark.parametrize("variant", ["cocitabs", "contexts"])
def test_filter_cocits_and_cocit_examples(tmp_path, variant, capsys):
    pid2abstract, cocits = corpus(32, n_sets=20)
    with open(tmp_path / "cocits.pickle", "wb") as f:
        pickle.dump(cocits, f)
    with open(tmp_path / "abstracts.pickle", "wb") as f:
        pickle.dump(pid2abstract, f)
    for main, tag in ((port_main, "t"), (jax_main, "j")):
        main("filter-cocits", tmp_path / "cocits.pickle", tmp_path / f"{tag}.pickle")
        main("cocit-examples", tmp_path / f"{tag}.pickle", tmp_path / tag,
             {"abstracts": str(tmp_path / "abstracts.pickle"), "variant": variant,
              **LIMITS})
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed[0] == printed[2] and printed[1] == printed[3]
    assert pickle.loads((tmp_path / "t.pickle").read_bytes()) == \
        pickle.loads((tmp_path / "j.pickle").read_bytes())
    same_files(tmp_path / "t", tmp_path / "j")


def test_dataset_converters(tmp_path, capsys):
    """scidocs / relish / treccovid dispatch with their --extra options."""
    rng = np.random.default_rng(33)
    write_treccovid(tmp_path / "tc", 34)
    rel_abs, rel_ann = tmp_path / "rel", tmp_path / "relann"
    rel_abs.mkdir()
    rel_ann.mkdir()
    for i in range(8):
        (rel_abs / f"PubMed-{i}.txt").write_text(f"Title {i}\nOne sent. Two sent.\n")
    (rel_ann / "RELISH_v1_ann.json").write_text(json.dumps([
        {"pmid": str(q), "response": {"relevant": [str(c) for c in rng.choice(8, 3)],
                                      "partial": [], "irrelevant": ["7"]}}
        for q in range(4)]))
    sci = tmp_path / "sci"
    (sci / "cite").mkdir(parents=True)
    (sci / "paper_metadata_view_cite_read.json").write_text(json.dumps(
        {f"d{i}": {"title": f"T{i}", "abstract": "A b c. D e f.", "year": 2000}
         for i in range(5)}))
    (sci / "cite" / "val.qrel").write_text("d0 0 d1 1\nd0 0 d2 0\n")
    (sci / "cite" / "test.qrel").write_text("d3 0 d4 1\n")
    cases = [("treccovid", tmp_path / "tc", {"max_queries_per_topic": 2}),
             ("relish", rel_abs, {"ann_path": str(rel_ann), "split_seed": 3}),
             ("scidocs", sci, {"dataset_name": "cite"})]
    for action, src, extra in cases:
        port_main(action, src, tmp_path / f"t_{action}", dict(extra))
        jax_main(action, src, tmp_path / f"j_{action}", dict(extra))
        assert len(same_files(tmp_path / f"t_{action}", tmp_path / f"j_{action}")) == 4
    printed = capsys.readouterr().out.splitlines()
    assert printed[0::2] == printed[1::2]


def test_ner_subprocess(tmp_path):
    rng = np.random.default_rng(35)
    with open(tmp_path / "abstracts-x.jsonl", "w") as f:
        for i in range(6):
            f.write(json.dumps({"paper_id": f"p{i}", "title": "t", "abstract": [
                f"We use Optimal Transport (OT) and multi-vector {rng.integers(9)} sets.",
                "Graph Neural Networks help co-citation mining."]}) + "\n")
    run_cli(["ner", "--abstracts", str(tmp_path / "abstracts-x.jsonl"),
             "--out", str(tmp_path / "t-ner.jsonl")], tmp_path)
    jner.write_ner_file(str(tmp_path / "abstracts-x.jsonl"), str(tmp_path / "j-ner.jsonl"))
    assert (tmp_path / "t-ner.jsonl").read_bytes() == (tmp_path / "j-ner.jsonl").read_bytes()
    proc = run_cli(["ner", "--abstracts", str(tmp_path / "abstracts-x.jsonl"),
                    "--out", str(tmp_path / "s.jsonl"), "--extractor", "scispacy",
                    "--device", "cpu"], tmp_path, check=False)
    assert proc.returncode != 0 and "simple_entity_extractor" in proc.stderr


def _flags(parser, name) -> set:
    sub = next(a for a in parser._actions
               if getattr(a, "choices", None) and "train" in a.choices)
    return {s for a in sub.choices[name]._actions for s in a.option_strings}


@pytest.mark.parametrize("name", ["preprocess", "ner"])
def test_flags_are_the_jax_parsers_plus_device(name):
    from aspire_tpu.cli import build_parser as jax_parser
    assert _flags(cli.build_parser(), name) == _flags(jax_parser(), name) | {"--device"}
    # and the same actions and extractor choices
    for parser in (cli.build_parser(), jax_parser()):
        sub = next(a for a in parser._actions
                   if getattr(a, "choices", None) and "train" in a.choices)
        acts = {a.dest: a.choices for a in sub.choices[name]._actions if a.choices}
        if name == "preprocess":
            assert acts["action"] == ["gorc", "cocit-examples", "regen-examples",
                                      "relish", "treccovid", "scidocs",
                                      "filter-cocits"]
        else:
            assert acts["extractor"] == ["simple", "scispacy"]
