"""Evaluation dataset loaders (file-contract compatible with the reference;
the port's own copy of aspire_tpu/evaluation/datasets.py, without pandas).

Same on-disk layout as src/evaluation/utils/datasets.py:7-128:
  abstracts-{name}.jsonl            {'paper_id', 'title', 'abstract'[, 'pred_labels']}
  {name}-ner.jsonl                  optional NER entity json
  test-pid2anns-{name}[-facet].json {qpid: {'cands': [...], 'relevance_adju': [...]}}
  {name}-queries-release.csv        query metadata
  {name}-evaluation_splits.json     dev/test query splits
"""
from __future__ import annotations

import codecs
import csv
import json
import logging
import os

log = logging.getLogger(__name__)

FACETS = ("background", "method", "result")

# reference datasets that ship an evaluation_splits.json (ranking_eval.py
# reads one for each; csfcube uses folds instead)
_SPLIT_FILE_DATASETS = frozenset(
    {"relish", "treccovid", "scidcite", "scidcocite", "scidcoread",
     "scidcoview"})


class EvalDataset:
    """One evaluation dataset rooted at a directory."""

    def __init__(self, name: str, root_path: str):
        self.name = name
        self.root_path = root_path
        self.dataset = self._load_abstracts(
            os.path.join(root_path, f"abstracts-{name}.jsonl"))
        self.ner_data = self._load_ner()

    @staticmethod
    def _load_abstracts(fname: str) -> dict:
        out = {}
        with codecs.open(fname, "r", "utf-8") as f:
            for line in f:
                d = json.loads(line.strip())
                rec = {"TITLE": d["title"], "ABSTRACT": d["abstract"]}
                if "pred_labels" in d:
                    rec["FACETS"] = d["pred_labels"]
                out[d["paper_id"]] = rec
        return out

    def _load_ner(self):
        fname = os.path.join(self.root_path, f"{self.name}-ner.jsonl")
        if os.path.exists(fname):
            with codecs.open(fname, "r", "utf-8") as f:
                return json.load(f)
        return None

    def get(self, pid: str) -> dict:
        data = self.dataset[pid]
        if self.ner_data is not None:
            return {**data, "ENTITIES": self.ner_data[pid]}
        return data

    def _anns_path(self, facet=None) -> str:
        suffix = f"-{facet}" if facet else ""
        return os.path.join(self.root_path, f"test-pid2anns-{self.name}{suffix}.json")

    def get_test_pool(self, facet=None) -> dict:
        with codecs.open(self._anns_path(facet), "r", "utf-8") as f:
            return json.load(f)

    def get_gold_test_data(self, facet=None) -> dict:
        """{query_id: {candidate_id: relevance}}"""
        with codecs.open(self._anns_path(facet), "r", "utf-8") as f:
            return {k: dict(zip(v["cands"], v["relevance_adju"]))
                    for k, v in json.load(f).items()}

    def get_query_metadata(self) -> dict:
        """{pid (str): {column: value (str)}} from the queries CSV; the
        JAX package returns the same rows as a pandas frame indexed by pid."""
        fname = os.path.join(self.root_path, f"{self.name}-queries-release.csv")
        with open(fname, newline="", encoding="utf-8") as f:
            return {str(row["pid"]): {k: v for k, v in row.items() if k != "pid"}
                    for row in csv.DictReader(f)}

    def get_test_dev_split(self):
        if self.name == "csfcube":
            return None  # whole dataset is test; folds handle dev/test
        fname = os.path.join(self.root_path, f"{self.name}-evaluation_splits.json")
        if not os.path.exists(fname):
            if self.name in _SPLIT_FILE_DATASETS:
                # these reference datasets SHIP a split file; a missing one
                # means a wrong root_path, and a silent plain-mean fallback
                # would report protocol-breaking aggregates that look valid
                raise FileNotFoundError(
                    f"{fname} missing: {self.name} is evaluated with a "
                    "dev/test split file (check --root-path)")
            # ad-hoc/plugin datasets without a split file aggregate as one
            # test split (the documented plain-mean path)
            log.warning("no %s; aggregating %s as a single plain-mean "
                        "'test' split", os.path.basename(fname), self.name)
            return None
        with codecs.open(fname, "r", "utf-8") as f:
            return json.load(f)

    def get_threshold_grade(self) -> int:
        """Binarization threshold (utils/datasets.py:118-125)."""
        if self.name in {"treccovid", "scidcite", "scidcocite", "scidcoread", "scidcoview"}:
            return 1
        return 2

    def __iter__(self):
        return iter(self.dataset.items())
