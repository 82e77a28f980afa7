"""The port's data/gorc.py and data/corpus.py against the JAX package's on a
synthetic S2ORC-shaped corpus of batch files (.jsonl and .jsonl.gz, made
from a numpy seed): every file written must be equal byte for byte and every
returned value equal (tolerance: none); the co-citation pickles must
unpickle to equal dicts.  A partials directory written by one package is
read by the other's regenerate_examples.  One case runs the port's spawn
pool (processes=2): each worker imports torch, so it is kept to one."""
import gzip
import json
import pathlib
import pickle
import zlib

import numpy as np
import pytest

from aspire_tpu.data import corpus as jcorpus
from aspire_tpu.data import gorc as jgorc
from aspire_tpu_torch.data import corpus as tcorpus
from aspire_tpu_torch.data import gorc as tgorc

WORDS = ("graph neural attention transport sentence encoder corpus citation "
         "retrieval ranking vector token model data method result").split()


def same_files(a: pathlib.Path, b: pathlib.Path) -> list:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        if name.endswith(".pickle"):
            assert pickle.loads((a / name).read_bytes()) == \
                pickle.loads((b / name).read_bytes()), name
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


def sentence(rng, lo=4, hi=9) -> str:
    words = list(rng.choice(WORDS, int(rng.integers(lo, hi))))
    return " ".join([words[0].capitalize()] + words[1:]) + "."


def cited_paper(rng, pid):
    return {"paper_id": pid, "title": f"cited paper {pid}",
            "abstract": " ".join(sentence(rng) for _ in range(int(rng.integers(3, 6))))}


def citing_paper(rng, pid, bib):
    par = (f"We build on the {rng.choice(WORDS)} systems [1] and [2] for "
           f"{rng.choice(WORDS)} tasks. {sentence(rng)} Also [3] helps here "
           "in many ways.")
    spans = [{"start": par.index(f"[{i + 1}]"), "end": par.index(f"[{i + 1}]") + 3,
              "ref_id": f"BIBREF{i}"} for i in range(3)]
    spans.append({"start": 0, "end": 2, "ref_id": None})
    paper = {"paper_id": pid, "title": f"citing paper {pid}",
             "abstract": " ".join(sentence(rng) for _ in range(4)),
             "grobid_parse": {
                 "bib_entries": {f"BIBREF{i}": {"links": b} for i, b in enumerate(bib)},
                 "body_text": [{"text": par, "cite_spans": spans},
                               {"text": sentence(rng), "cite_spans": []}]}}
    # the full-text flags a metadata row may carry
    flag = int(rng.integers(0, 3))
    if flag == 0:
        paper["has_grobid"] = True
    elif flag == 1:
        paper["has_grobid_text"] = True
    return paper


def write_corpus(root: pathlib.Path, seed: int, n_files: int = 6) -> list:
    """Batch files of cited and citing papers; half gzipped; citing papers
    co-cite pairs of 12 cited papers."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    cited = [f"c{i}" for i in range(12)]
    papers = [cited_paper(rng, p) for p in cited]
    papers[3]["abstract"] = "Too short."                  # fails the noise filter
    for k in range(24):
        bib = list(rng.choice(cited, 3, replace=False))
        if k % 5 == 0:
            bib[2] = ""                                   # an unlinked entry
        papers.append(citing_paper(rng, f"p{k}", bib))
    order = rng.permutation(len(papers))
    for b in range(n_files):
        lines = "".join(json.dumps(papers[i]) + "\n" for i in order[b::n_files])
        if b % 2:
            with gzip.open(root / f"{b}.jsonl.gz", "wt") as f:
                f.write(lines)
        else:
            (root / f"{b}.jsonl").write_text(lines)
    (root / "README.txt").write_text("not a batch file")
    return papers


def hashed_aligner(dim: int = 32):
    def embed(sents):
        out = np.zeros((len(sents), dim), np.float32)
        for i, s in enumerate(sents):
            for w in s.lower().split():
                out[i, zlib.crc32(w.encode()) % dim] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)
    return embed


@pytest.fixture(scope="module")
def batch_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("gorc") / "corpus"
    write_corpus(root, seed=7)
    return root


@pytest.fixture(scope="module")
def papers(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("gorc_p") / "c", seed=8)


# ------------------------------------------------------------------- gorc.py
def test_filter_metadata_equal(papers):
    rows = papers + [
        {"paper_id": "x1", "has_grobid_text": True, "abstract": "a", "title": "t",
         "has_pdf_parse": False},
        {"paper_id": "x2", "has_grobid": True, "abstract": "", "title": "t"},
        {"paper_id": "x3", "has_grobid": True, "abstract": "a", "title": "t",
         "field": float("nan")},
        {"paper_id": "x4", "has_grobid": True, "abstract": "a", "title": "t",
         "field": "cs"}]
    for kw in ({}, {"filter_nan_cols": ["field"]},
               {"require_fields": ("abstract",)}):
        got = tgorc.filter_metadata(rows, **kw)
        assert got == jgorc.filter_metadata(rows, **kw)
    for v in (None, "", float("nan"), 0.0, "x", 3):
        assert tgorc._is_nan(v) == jgorc._is_nan(v)


def test_citation_contexts_equal(papers, tmp_path):
    for p in papers + [{"paper_id": "e"}, {"paper_id": "f", "grobid_parse": {}}]:
        assert tgorc.extract_citation_contexts(p) == jgorc.extract_citation_contexts(p)
    n = tgorc.write_citation_contexts(papers, str(tmp_path / "t.jsonl"))
    assert n == jgorc.write_citation_contexts(papers, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert tgorc.gather_cocitations(lines) == jgorc.gather_cocitations(lines)
    got = tgorc.gather_cocitations_file(str(tmp_path / "t.jsonl"),
                                        str(tmp_path / "t.pickle"),
                                        str(tmp_path / "t1.pickle"))
    assert got == jgorc.gather_cocitations_file(str(tmp_path / "j.jsonl"),
                                                str(tmp_path / "j.pickle"),
                                                str(tmp_path / "j1.pickle"))
    for name in ("", "1"):
        assert pickle.loads((tmp_path / f"t{name}.pickle").read_bytes()) == \
            pickle.loads((tmp_path / f"j{name}.pickle").read_bytes())
    pid2area = {f"p{k}": ("compsci" if k % 3 else "biomed") for k in range(24)}
    assert list(tgorc.filter_area_citcontexts(lines, pid2area, "biomed")) == \
        list(jgorc.filter_area_citcontexts(lines, pid2area, "biomed"))


def test_gather_papers_and_abstracts_equal(papers, batch_dir):
    files = tcorpus.list_batch_files(str(batch_dir))
    plain = [f for f in files if f.endswith(".jsonl")]
    pids = {"c1", "c5", "p3", "p17", "nope"}
    assert tgorc.gather_papers(pids, plain) == jgorc.gather_papers(pids, plain)
    assert tgorc.filter_corpus_abstracts(papers) == \
        jgorc.filter_corpus_abstracts(papers)


# ----------------------------------------------------------------- corpus.py
def test_batch_files_and_worker_equal(batch_dir, tmp_path):
    files = tcorpus.list_batch_files(str(batch_dir))
    assert files == jcorpus.list_batch_files(str(batch_dir))
    assert len(files) == 6 and sum(f.endswith(".gz") for f in files) == 3
    assert [tcorpus._batch_tag(f) for f in files] == \
        [jcorpus._batch_tag(f) for f in files]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for f in files[:2]:                      # one plain, one gzipped
        assert tcorpus.process_batch_file((f, str(tmp_path / "t"))) == \
            jcorpus.process_batch_file((f, str(tmp_path / "j")))
    assert len(same_files(tmp_path / "t", tmp_path / "j")) == 4


@pytest.mark.parametrize("area", [None, "compsci"])
def test_run_gorc_pipeline_files_equal(batch_dir, tmp_path, area):
    kw = dict(processes=1, train_size=100, dev_size=100)
    if area:
        kw.update(area=area, pid2area={f"p{k}": ("compsci" if k % 3 else "biomed")
                                       for k in range(24)})
    got = tcorpus.run_gorc_pipeline(str(batch_dir), str(tmp_path / "t"), **kw)
    assert got == jcorpus.run_gorc_pipeline(str(batch_dir), str(tmp_path / "j"), **kw)
    names = same_files(tmp_path / "t", tmp_path / "j")
    assert f"cocitpids2contexts-{area or 'all'}.pickle" in names
    assert {"gorc-summary.json", "train-cocitabs.jsonl", "dev-cocitabs.jsonl",
            "train-coppsent.jsonl", "dev-coppsent.jsonl"} <= set(names)
    assert got["cocited_sets"] > 0 and got["examples"]["train"] > 0


def test_run_gorc_pipeline_spawn_pool_and_aligner_equal(batch_dir, tmp_path):
    """The port's spawn pool (two workers) with an aligner against the JAX
    package in one process: the same files."""
    got = tcorpus.run_gorc_pipeline(str(batch_dir), str(tmp_path / "t"),
                                    processes=2, train_size=100, dev_size=100,
                                    aligner=hashed_aligner())
    assert got == jcorpus.run_gorc_pipeline(
        str(batch_dir), str(tmp_path / "j"), processes=1, train_size=100,
        dev_size=100, aligner=hashed_aligner())
    assert "train-cocitabsalign.jsonl" in same_files(tmp_path / "t", tmp_path / "j")


def test_run_gorc_pipeline_refuses_an_empty_directory(tmp_path):
    (tmp_path / "empty").mkdir()
    for pkg in (tcorpus, jcorpus):
        with pytest.raises(FileNotFoundError, match="no .jsonl"):
            pkg.run_gorc_pipeline(str(tmp_path / "empty"), str(tmp_path / "o"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_regenerate_examples_across_packages(batch_dir, tmp_path, writer):
    """Partials written by one package, regenerated by both (with an
    aligner and without): the same example files."""
    make = jcorpus if writer == "jax" else tcorpus
    make.run_gorc_pipeline(str(batch_dir), str(tmp_path / "partials"),
                           processes=1, train_size=100, dev_size=100)
    for aligner in (None, hashed_aligner()):
        tag = "plain" if aligner is None else "aligned"
        got = tcorpus.regenerate_examples(str(tmp_path / "partials"),
                                          str(tmp_path / f"t_{tag}"),
                                          train_size=100, dev_size=100,
                                          aligner=aligner)
        assert got == jcorpus.regenerate_examples(
            str(tmp_path / "partials"), str(tmp_path / f"j_{tag}"),
            train_size=100, dev_size=100, aligner=aligner)
        same_files(tmp_path / f"t_{tag}", tmp_path / f"j_{tag}")
    pid2abstract = tcorpus._load_abstract_partials(tmp_path / "partials")
    assert pid2abstract == jcorpus._load_abstract_partials(tmp_path / "partials")
