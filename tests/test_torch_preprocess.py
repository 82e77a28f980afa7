"""The port's data/preprocess.py against the JAX package's on the same inputs
(made from a numpy seed): every file written must be equal byte for byte
(tolerance: none), and the in-memory results equal.

Sentencization is the regex branch on both sides (spacy is not installed);
the spacy branches are not tested.  TREC-COVID's metadata is read by pandas
in the JAX package and by `csv` in the port: the file holds a bad line,
empty cells, pandas' NA markers and a short row."""
import csv
import json
import pathlib
import zlib

import numpy as np
import pytest

from aspire_tpu.data import preprocess as jpp
from aspire_tpu_torch.data import preprocess as tpp

WORDS = ("graph neural attention transport sentence encoder corpus citation "
         "retrieval ranking vector token model data method result").split()


def same_files(a: pathlib.Path, b: pathlib.Path) -> list:
    """Both directories hold the same file names with the same bytes."""
    names_a = sorted(p.name for p in a.iterdir())
    assert names_a == sorted(p.name for p in b.iterdir())
    for name in names_a:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names_a


def sentence(rng, lo=4, hi=9) -> str:
    words = list(rng.choice(WORDS, int(rng.integers(lo, hi))))
    return " ".join([words[0].capitalize()] + words[1:]) + "."


def corpus(seed: int, n_papers: int = 30, n_sets: int = 12):
    """pid2abstract and co-citations {(pids): [(citing_pid, context)]}."""
    rng = np.random.default_rng(seed)
    pids = [f"p{i}" for i in range(n_papers)]
    pid2abstract = {p: {"title": f"title {p}",
                        "abstract": [sentence(rng)
                                     for _ in range(int(rng.integers(3, 7)))]}
                    for p in pids}
    cocits = {}
    for k in range(n_sets):
        group = tuple(sorted(rng.choice(pids, int(rng.integers(2, 4)),
                                        replace=False)))
        cocits[group] = [(f"c{k}_{j}", f"we cite [{j}] in {sentence(rng, 5, 12)}")
                         for j in range(int(rng.integers(2, 5)))]
    return pid2abstract, cocits


def hashed_aligner(dim: int = 32):
    """A deterministic sentence embedder (hashed bag of words, unit rows)."""
    def embed(sents):
        out = np.zeros((len(sents), dim), np.float32)
        for i, s in enumerate(sents):
            for w in s.lower().split():
                out[i, zlib.crc32(w.encode()) % dim] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)
    return embed


@pytest.mark.parametrize("text", [
    "First sentence here. Second one too! Third (v2.0) ends.",
    "  Leading space. e.g. lower case stays. 3 numbers start? Yes.",
    "No terminal punctuation at all",
    "",
    "Dr. Smith went home. He slept.\nA new line. Tabs\tinside.",
])
def test_sentencize_regex_branch_equal(text):
    assert tpp.sentencize(text) == jpp.sentencize(text)


def test_noise_filters_equal():
    assert (tpp.MIN_ABS_LEN, tpp.MAX_ABS_LEN, tpp.MIN_NUM_TOKS,
            tpp.MAX_NUM_TOKS) == (jpp.MIN_ABS_LEN, jpp.MAX_ABS_LEN,
                                  jpp.MIN_NUM_TOKS, jpp.MAX_NUM_TOKS)
    ok = ["one two three four five."] * 5
    for sents in (ok, ok[:2], ok * 5, ok + ["a b c"], ok + ["w " * 85], []):
        assert tpp.exclude_abstract(sents) == jpp.exclude_abstract(sents)
    rng = np.random.default_rng(3)
    _, cocits = corpus(3, n_sets=30)
    cocits[("a", "b", "c", "d")] = [("x", "four cocited papers get dropped [7]")]
    cocits[("e", "f")] = [("y", "x " * 70 + "[8]"), ("z", "no brackets here at all ok")]
    cocits[("g", "h")] = [("p1", "we follow [1] and (2) in this method of it"),
                          ("p2", "we follow [4] and (5) in this method of it"),
                          ("p1", f"again [3] {sentence(rng)}")]
    got = tpp.filter_cocitation_contexts(cocits)
    assert got == jpp.filter_cocitation_contexts(cocits)
    assert ("a", "b", "c", "d") not in got and len(got[("g", "h")]) == 1


@pytest.mark.parametrize("aligned", [False, True])
def test_generate_examples_cocitabs_files_equal(tmp_path, aligned):
    pid2abstract, cocits = corpus(11)
    kw = {"aligner": hashed_aligner()} if aligned else {}
    got = tpp.generate_examples_cocitabs(cocits, pid2abstract,
                                         str(tmp_path / "t"), train_size=100,
                                         dev_size=100, **kw)
    want = jpp.generate_examples_cocitabs(cocits, pid2abstract,
                                          str(tmp_path / "j"), train_size=100,
                                          dev_size=100, **kw)
    assert got == want
    names = same_files(tmp_path / "t", tmp_path / "j")
    suffix = "cocitabsalign" if aligned else "cocitabs"
    assert names == [f"dev-{suffix}.jsonl", f"train-{suffix}.jsonl"]
    first = json.loads((tmp_path / "t" / names[1]).read_text().splitlines()[0])
    assert ("cc_align" in first["pos_context"]) == aligned


def test_generate_examples_cocitabs_limits_and_suffix_equal(tmp_path):
    pid2abstract, cocits = corpus(12, n_sets=20)
    for pkg, d in ((tpp, "t"), (jpp, "j")):
        pkg.generate_examples_cocitabs(cocits, pid2abstract, str(tmp_path / d),
                                       train_size=3, dev_size=1, seed=5,
                                       suffix="custom")
    assert same_files(tmp_path / "t", tmp_path / "j") == [
        "dev-custom.jsonl", "train-custom.jsonl"]


def test_generate_examples_sent_rand_files_equal(tmp_path):
    _, cocits = corpus(13, n_sets=25)
    got = tpp.generate_examples_sent_rand(cocits, str(tmp_path / "t"))
    assert got == jpp.generate_examples_sent_rand(cocits, str(tmp_path / "j"))
    assert same_files(tmp_path / "t", tmp_path / "j") == [
        "dev-coppsent.jsonl", "train-coppsent.jsonl"]
    assert got["train"] > 0 and got["dev"] > 0


def test_generate_examples_cocitabs_contexts_files_equal(tmp_path):
    pid2abstract, cocits = corpus(14, n_sets=15)
    got = tpp.generate_examples_cocitabs_contexts(
        cocits, pid2abstract, str(tmp_path / "t"), train_size=100, dev_size=100)
    assert got == jpp.generate_examples_cocitabs_contexts(
        cocits, pid2abstract, str(tmp_path / "j"), train_size=100, dev_size=100)
    assert same_files(tmp_path / "t", tmp_path / "j") == [
        "dev-concocitabs-seq.jsonl", "train-concocitabs-seq.jsonl"]


def test_generate_examples_ict_files_equal(tmp_path):
    pid2abstract, _ = corpus(15)
    pid2abstract["short"] = {"title": "t", "abstract": ["Only one sentence."]}
    got = tpp.generate_examples_ict(pid2abstract, str(tmp_path / "t"), 40)
    assert got == jpp.generate_examples_ict(pid2abstract, str(tmp_path / "j"), 40)
    assert same_files(tmp_path / "t", tmp_path / "j") == ["train-ict.jsonl"]


def test_scidocs_to_common_files_equal(tmp_path):
    rng = np.random.default_rng(16)
    in_dir = tmp_path / "in"
    (in_dir / "cite").mkdir(parents=True)
    meta = {f"d{i}": {"title": f"T{i}", "year": 2000 + i,
                      "abstract": " ".join(sentence(rng) for _ in range(3))}
            for i in range(12)}
    meta["bad"] = {"title": None, "abstract": None, "year": 2020}
    meta["empty"] = {"title": "E", "abstract": "", "year": 2021}
    (in_dir / "paper_metadata_view_cite_read.json").write_text(json.dumps(meta))
    lines = {"val": [], "test": []}
    for q in range(4):
        split = "val" if q % 2 else "test"
        for c in rng.choice(12, 5, replace=False):
            lines[split].append(f"d{q} 0 d{c} {int(rng.integers(0, 2))}")
        lines[split].append(f"d{q} 0 bad 1")
    lines["val"].append("missing 0 d1 1")
    for split in ("val", "test"):
        (in_dir / "cite" / f"{split}.qrel").write_text("\n".join(lines[split]) + "\n")
    got = tpp.scidocs_to_common(str(in_dir), str(tmp_path / "t"), "cite")
    assert got == jpp.scidocs_to_common(str(in_dir), str(tmp_path / "j"), "cite")
    assert len(same_files(tmp_path / "t", tmp_path / "j")) == 4


def test_relish_to_common_files_equal(tmp_path):
    rng = np.random.default_rng(17)
    abs_dir, ann_dir = tmp_path / "abs", tmp_path / "ann"
    abs_dir.mkdir()
    ann_dir.mkdir()
    for i in range(14):
        body = "\n".join(sentence(rng) for _ in range(3)) if i != 5 else ""
        (abs_dir / f"PubMed-{100 + i}.txt").write_text(f"Title {i}\n{body}\n")
    (abs_dir / "notes.md").write_text("not an abstract")
    anns = []
    for q in range(6):
        pool = [str(100 + int(c)) for c in rng.choice(14, 9, replace=False)]
        anns.append({"pmid": str(100 + q), "response": {
            "relevant": pool[:3], "partial": pool[3:5] + pool[:1],
            "irrelevant": pool[5:] + ["999"]}})
    anns.append({"pmid": "404", "response": {"relevant": [], "partial": [],
                                             "irrelevant": []}})
    (ann_dir / "RELISH_v1_ann.json").write_text(json.dumps(anns))
    got = tpp.relish_to_common(str(abs_dir), str(ann_dir), str(tmp_path / "t"))
    assert got == jpp.relish_to_common(str(abs_dir), str(ann_dir),
                                       str(tmp_path / "j"))
    assert len(same_files(tmp_path / "t", tmp_path / "j")) == 4


def write_treccovid(in_dir: pathlib.Path, seed: int) -> None:
    """qrels over 4 topics and a metadata CSV with a bad line (one field too
    many), empty cells, NA markers, a short row and a duplicated id."""
    rng = np.random.default_rng(seed)
    in_dir.mkdir()
    qrels = []
    for t in range(4):
        for d in range(6):
            qrels.append(f"{t + 1} 5 doc{t}_{d} {2 if d < 5 else 1}")
    (in_dir / "qrels-covid_d5_j0.5-5.txt").write_text("\n".join(qrels) + "\n")
    header = ["cord_uid", "title", "abstract", "publish_time", "authors"]
    rows = []
    for t in range(4):
        for d in range(6):
            text = " ".join(sentence(rng) for _ in range(2))
            rows.append([f"doc{t}_{d}", f"Title, {t} {d}", text, "2020-01-01", "A"])
    rows[1][1] = ""                       # empty title
    rows[2][2] = ""                       # empty abstract
    rows[3][1] = "NA"                     # pandas reads NA as missing
    rows[4][2] = "null"
    rows.insert(6, rows[6][:] + ["one field too many"])     # a bad line
    rows.insert(9, rows[9][:3])           # a short row: its last cells missing
    rows.append(["doc0_0", "Duplicate title", "Dup abstract here. Two.", "x", "y"])
    with open(in_dir / "metadata-2021-06-21.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i, r in enumerate(rows):
            w.writerow(r)
            if i == 12:
                f.write("\n")             # a blank line


def test_treccovid_to_common_files_equal(tmp_path):
    write_treccovid(tmp_path / "tc", 18)
    got = tpp.treccovid_to_common(str(tmp_path / "tc"), str(tmp_path / "t"),
                                  max_queries_per_topic=3)
    want = jpp.treccovid_to_common(str(tmp_path / "tc"), str(tmp_path / "j"),
                                   max_queries_per_topic=3)
    assert got == want
    assert len(same_files(tmp_path / "t", tmp_path / "j")) == 4
    pids = [json.loads(line)["paper_id"] for line in
            (tmp_path / "t" / "abstracts-treccovid.jsonl").read_text().splitlines()]
    # the empty / NA cells drop four documents; the bad line's doc is gone
    assert len(pids) == len(set(pids)) == 20 - 4 - 1 + 1


def test_read_metadata_csv_matches_pandas(tmp_path):
    import pandas as pd
    write_treccovid(tmp_path / "tc", 19)
    path = tmp_path / "tc" / "metadata-2021-06-21.csv"
    meta = pd.read_csv(path, delimiter=",", on_bad_lines="skip", low_memory=False)
    rows = list(tpp._read_metadata_csv(str(path)))
    assert len(rows) == len(meta)
    for row, (_, want) in zip(rows, meta.iterrows()):
        for col in meta.columns:
            v = want[col]
            assert row[col] == (v if isinstance(v, str) else None), col
