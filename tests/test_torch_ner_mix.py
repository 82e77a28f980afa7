"""The port's data/ner.py and data/mix.py against the JAX package's on the
same inputs (made from a numpy seed): entity lists equal, files written equal
byte for byte (tolerance: none).  The scispacy extractor is tested only for
its ImportError guidance (spacy is not installed); its extraction is not."""
import json
import sys

import numpy as np
import pytest

from aspire_tpu.data import mix as jmix
from aspire_tpu.data import ner as jner
from aspire_tpu_torch.data import mix as tmix
from aspire_tpu_torch.data import ner as tner

TERMS = ["co-citation", "multi-vector", "Optimal Transport", "(BERT)", "(OT)",
         "Earth Mover Distance", "fine-grained", "e-mail", "x-ray-like",
         "Wasserstein", "sentence", "retrieval", "a", "of"]


def sentences(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(TERMS, int(rng.integers(3, 12)))) + "."
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simple_entity_extractor_equal(seed):
    sents = sentences(seed, 40) + [
        "We use Optimal Transport (OT) for co-citation alignment.",
        "Graph Neural Networks beat Earth Mover Distance. Then Dense Retrieval.",
        "", "(A)", "Lowercase only here with multi-vector-ish-long-term words."]
    for s in sents:
        assert tner.simple_entity_extractor(s) == jner.simple_entity_extractor(s)


def test_scispacy_extractor_guidance(monkeypatch):
    monkeypatch.setitem(sys.modules, "spacy", None)      # not importable
    for pkg in (tner, jner):
        with pytest.raises(ImportError, match="simple_entity_extractor"):
            pkg.scispacy_entity_extractor("en_core_sci_sm")


def test_write_ner_file_equal(tmp_path):
    rng = np.random.default_rng(5)
    with open(tmp_path / "abstracts-x.jsonl", "w") as f:
        for i in range(20):
            f.write(json.dumps({"paper_id": f"p{i}", "title": "t",
                                "abstract": sentences(i, int(rng.integers(1, 6)))}) + "\n")
    src = str(tmp_path / "abstracts-x.jsonl")
    assert tner.write_ner_file(src, str(tmp_path / "t.json")) == \
        jner.write_ner_file(src, str(tmp_path / "j.json")) == 20
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()

    def upper(s):
        return [w for w in s.split() if w[:1].isupper()]
    tner.write_ner_file(src, str(tmp_path / "t2.json"), upper)
    jner.write_ner_file(src, str(tmp_path / "j2.json"), upper)
    assert (tmp_path / "t2.json").read_bytes() == (tmp_path / "j2.json").read_bytes()


def test_sample_merge_and_shuffle_equal(tmp_path):
    rng = np.random.default_rng(6)
    inputs = []
    for k in range(3):
        path = tmp_path / f"in{k}.jsonl"
        lines = [json.dumps({"k": k, "i": i, "v": float(rng.normal())})
                 for i in range(int(rng.integers(10, 30)))]
        path.write_text("\n".join(lines) + "\n\n")
        inputs.append((str(path), int(rng.integers(5, 40))))
    assert tmix.sample_merge(inputs, str(tmp_path / "t.jsonl"), seed=3) == \
        jmix.sample_merge(inputs, str(tmp_path / "j.jsonl"), seed=3)
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    for seed in (0, 9):
        assert tmix.shuffle_file(str(tmp_path / "t.jsonl"),
                                 str(tmp_path / f"ts{seed}.jsonl"), seed) == \
            jmix.shuffle_file(str(tmp_path / "t.jsonl"),
                              str(tmp_path / f"js{seed}.jsonl"), seed)
        assert (tmp_path / f"ts{seed}.jsonl").read_bytes() == \
            (tmp_path / f"js{seed}.jsonl").read_bytes()
