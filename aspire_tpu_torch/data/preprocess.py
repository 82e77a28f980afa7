"""Offline data-preparation pipelines (host tooling), the port's copy of
aspire_tpu/data/preprocess.py: the same functions, files and RNG streams.

Re-implements the reference's pre-processing layer contracts
(src/pre_process/) as pure, testable functions + a CLI dispatcher:

  * abstract noise filtering (pp_settings.py:1-5 constants)
  * co-citation filtering (pre_proc_cocits.py:94-264)
  * training-example generation, incl. the tsAspire pre-alignment supervision
    with a pluggable sentence encoder (pre_proc_cocits.py:267-609)
  * eval-dataset converters to the common file layout: RELISH
    (pre_proc_relish.py:44-130), TRECCOVID-RF reformulation
    (pre_proc_treccovid.py:111-290), SciDocs (pre_proc_scidocs.py:17-122)

Sentencization uses scispacy when importable and a regex fallback otherwise
(spacy and its models are optional downloads; the file contracts are
unchanged).  Only the aligner (`_extra_aligner`, data/align.py) touches the
device; everything else runs on the host.  TREC-COVID's metadata is read
with `csv` where the JAX package uses pandas (`_read_metadata_csv`).
"""
from __future__ import annotations

import codecs
import collections
import csv
import itertools
import json
import os
import random
import re

import numpy as np

# Abstract noise-filter constants (reference pp_settings.py:1-5).
MIN_ABS_LEN = 3
MAX_ABS_LEN = 20
MAX_NUM_TOKS = 80
MIN_NUM_TOKS = 4


# ----------------------------------------------------------------------
def sentencize(text: str) -> list[str]:
    """scispacy sentence split when available; regex fallback otherwise."""
    try:
        import spacy  # noqa: F401
        nlp = _get_spacy()
        if nlp is not None:
            return [s.text for s in nlp(text).sents]
    except ImportError:
        pass
    # Regex fallback: split on sentence punctuation followed by whitespace +
    # uppercase/digit; keeps abbreviations like "e.g." together often enough.
    parts = re.split(r"(?<=[.!?])\s+(?=[A-Z0-9])", text.strip())
    return [p for p in (s.strip() for s in parts) if p]


_SPACY_CACHE = {}


def _get_spacy():
    if "nlp" not in _SPACY_CACHE:
        try:
            import spacy
            nlp = spacy.load(
                "en_core_sci_sm",
                disable=["tok2vec", "tagger", "attribute_ruler", "lemmatizer",
                         "parser", "ner"])
            # with the parser disabled doc.sents needs an explicit
            # sentencizer (the reference adds one too, pre_proc_cocits.py:25)
            if "sentencizer" not in nlp.pipe_names:
                nlp.add_pipe("sentencizer")
            _SPACY_CACHE["nlp"] = nlp
        except Exception:
            _SPACY_CACHE["nlp"] = None
    return _SPACY_CACHE["nlp"]


def exclude_abstract(abstract_sents: list[str]) -> bool:
    """True if the abstract is noise (pre_proc_gorc.py exclude_abstract):
    too few/many sentences or any absurdly long/short sentence."""
    if len(abstract_sents) < MIN_ABS_LEN or len(abstract_sents) > MAX_ABS_LEN:
        return True
    for sent in abstract_sents:
        n = len(sent.split())
        if n > MAX_NUM_TOKS or n < MIN_NUM_TOKS:
            return True
    return False


# ----------------------------------------------------------------------
def filter_cocitation_contexts(cocitpids2contexts: dict) -> dict:
    """Noise-filter co-citation contexts (pre_proc_cocits.py:94-176).

    cocitpids2contexts: {(pid, ...): [(citing_pid, context_sentence), ...]}
      * drop co-citations of > 3 papers
      * drop duplicate contexts (numerals stripped before comparison)
      * one context per citing paper
      * 5-60 tokens; must contain () or [] (else it's a spurious tag)
    """
    out = {}
    for cocitpids, contexts in cocitpids2contexts.items():
        if len(cocitpids) > 3:
            continue
        con2pids = collections.defaultdict(list)
        for sc in contexts:
            con2pids[re.sub(r"\d", "", sc[1])].append(sc)
        uniq = [ctxs[0] for ctxs in con2pids.values()]
        fcons = []
        citing = set()
        for citing_pid, sent in uniq:
            if citing_pid in citing:
                continue
            n = len(sent.split())
            if n > 60 or n < 5:
                continue
            if ("(" not in sent and ")" not in sent) and \
               ("[" not in sent and "]" not in sent):
                continue
            fcons.append((citing_pid, sent))
            citing.add(citing_pid)
        if fcons:
            out[tuple(cocitpids)] = fcons
    return out


def generate_examples_cocitabs(cocits: dict, pid2abstract: dict, out_dir: str,
                               train_size: int = 1_276_820,
                               dev_size: int = 10_000, seed: int = 69306,
                               aligner=None, suffix: str | None = None) -> dict:
    """Co-cited abstract pair examples, optionally with sentence alignments.

    cocits: filtered {(pids): [(citing_pid, context), ...]}.
    aligner: callable(list[str]) -> np.ndarray embedding matrix; when given,
    each positive carries `cc_align` (query-sent, pos-sent via most-similar
    co-citation context) and `abs_align` (direct argmax q-sent x pos-sent)
    exactly like generate_examples_aligned_cocitabs_rand
    (pre_proc_cocits.py:378-537).  Dev examples get frozen random negatives
    with random alignments.  Returns counts.
    """
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    if suffix is None:
        suffix = "cocitabsalign" if aligner is not None else "cocitabs"
    all_cocits = list(cocits.keys())
    rng.shuffle(all_cocits)
    rng.shuffle(all_cocits)
    n = len(all_cocits)
    split_copids = {"train": all_cocits[: int(0.8 * n)],
                    "dev": all_cocits[int(0.8 * n):]}
    limits = {"train": train_size, "dev": dev_size}
    all_abs_pids = list(pid2abstract.keys())

    emb_cache: dict[str, np.ndarray] = {}

    def sent_reps(sents: list[str]) -> np.ndarray:
        missing = [s for s in sents if s not in emb_cache]
        if missing:
            reps = np.asarray(aligner(missing))
            for s, r in zip(missing, reps):
                emb_cache[s] = r
        return np.stack([emb_cache[s] for s in sents])

    counts = {}
    for split, copids in split_copids.items():
        path = os.path.join(out_dir, f"{split}-{suffix}.jsonl")
        n_out = 0
        with codecs.open(path, "w", "utf-8") as f:
            for cocitedpids in copids:
                contexts = cocits[cocitedpids]
                ctx = rng.sample(contexts, min(10, len(contexts)))
                context_sents = [c[1] for c in ctx]
                citing_pids = [c[0] for c in ctx]
                for i, j in itertools.combinations(range(len(cocitedpids)), 2):
                    apid, ppid = cocitedpids[i], cocitedpids[j]
                    anchor = pid2abstract[apid]
                    pos = pid2abstract[ppid]
                    pos_out = {"TITLE": pos["title"], "ABSTRACT": pos["abstract"]}
                    if aligner is not None:
                        q_reps = sent_reps(anchor["abstract"])
                        p_reps = sent_reps(pos["abstract"])
                        c_reps = sent_reps(context_sents)
                        q_ci = np.unravel_index(
                            (q_reps @ c_reps.T).argmax(), (len(q_reps), len(c_reps)))
                        p_ci = np.unravel_index(
                            (p_reps @ c_reps.T).argmax(), (len(p_reps), len(c_reps)))
                        qp = np.unravel_index(
                            (q_reps @ p_reps.T).argmax(), (len(q_reps), len(p_reps)))
                        pos_out["cc_align"] = [int(q_ci[0]), int(p_ci[0])]
                        pos_out["abs_align"] = [int(qp[0]), int(qp[1])]
                    ex = {
                        "citing_pids": citing_pids,
                        "cited_pids": list(cocitedpids),
                        "query": {"TITLE": anchor["title"],
                                  "ABSTRACT": anchor["abstract"]},
                        "pos_context": pos_out,
                        "citing_contexts": context_sents,
                    }
                    if split == "dev":
                        npid = rng.choice(all_abs_pids)
                        neg = pid2abstract[npid]
                        neg_out = {"TITLE": neg["title"], "ABSTRACT": neg["abstract"]}
                        if aligner is not None:
                            neg_out["cc_align"] = [
                                rng.randrange(len(anchor["abstract"])),
                                rng.randrange(len(neg["abstract"]))]
                            neg_out["abs_align"] = [
                                rng.randrange(len(anchor["abstract"])),
                                rng.randrange(len(neg["abstract"]))]
                        ex["neg_context"] = neg_out
                    f.write(json.dumps(ex) + "\n")
                    n_out += 1
                if n_out > limits[split]:
                    break
        counts[split] = n_out
    return counts


def generate_examples_sent_rand(cocits_sent: dict, out_dir: str,
                                dev_frac: float = 0.2, seed: int = 57395) -> dict:
    """cosentbert sentence-paraphrase pairs from co-citation contexts
    (pre_proc_cocits.py:267-318), reference combinatorics and schema:

      * ALL length-2 combinations of each co-cited group's contexts become
        (query, pos_context) pairs — NOT one sampled pair per group — so a
        group with n contexts yields C(n, 2) examples;
      * `citing_pids` (anchor's, positive's) and `cited_pids` metadata ride
        on every example;
      * query / pos_context / neg_context are RAW SENTENCE STRINGS
        (train-coppsent.jsonl contract; TripleStream wraps them);
      * the shuffled groups split 80/20 train/dev in order, and each dev
        example gets a frozen negative drawn from the DEV split's groups.

    RNG-stream deviation (documented, PARITY.md): random.Random(seed)
    replaces the reference's module-level random.seed, so the concrete
    shuffle/negative draws differ; the distribution and combinatorics
    match."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    keys = list(cocits_sent.keys())
    rng.shuffle(keys)
    rng.shuffle(keys)
    n_train = len(keys) - int(dev_frac * len(keys))
    split_keys = {"train": keys[:n_train], "dev": keys[n_train:]}
    counts = {}
    for split, skeys in split_keys.items():
        path = os.path.join(out_dir, f"{split}-coppsent.jsonl")
        n_out = 0
        with codecs.open(path, "w", "utf-8") as f:
            for k in skeys:
                ctxs = cocits_sent[k]
                for i, j in itertools.combinations(range(len(ctxs)), 2):
                    anchor, pos = ctxs[i], ctxs[j]
                    ex = {"citing_pids": [anchor[0], pos[0]],
                          "cited_pids": list(k),
                          "query": anchor[1],
                          "pos_context": pos[1]}
                    if split == "dev":
                        neg_ctxs = cocits_sent[rng.choice(skeys)]
                        ex["neg_context"] = rng.choice(neg_ctxs)[1]
                    f.write(json.dumps(ex) + "\n")
                    n_out += 1
        counts[split] = n_out
    return counts


def generate_examples_cocitabs_contexts(cocits: dict, pid2abstract: dict,
                                        out_dir: str,
                                        train_size: int = 1_276_820,
                                        dev_size: int = 10_000,
                                        seed: int = 69306) -> dict:
    """Co-cited abstract pairs with the citing CONTEXTS bundled into the
    positive — the cospecter-contexts training variant
    (pre_proc_cocits.py generate_examples_cocitabs_contexts_rand:612-699).

    Differences from generate_examples_cocitabs: the (<= 10 sampled)
    citing_contexts + citing_pids live INSIDE pos_context (and the dev
    neg_context), not at the example top level, and dev negatives are drawn
    from a VALID co-cite set (so they come with their own contexts) rather
    than from the abstract corpus.  File suffix: concocitabs-seq."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    all_cocits = list(cocits.keys())
    rng.shuffle(all_cocits)
    rng.shuffle(all_cocits)
    n = len(all_cocits)
    split_copids = {"train": all_cocits[: int(0.8 * n)],
                    "dev": all_cocits[int(0.8 * n):]}
    limits = {"train": train_size, "dev": dev_size}

    def sampled_contexts(copids):
        ctx = rng.sample(cocits[copids], min(10, len(cocits[copids])))
        return [c[1] for c in ctx], [c[0] for c in ctx]

    counts = {}
    for split, copids_list in split_copids.items():
        path = os.path.join(out_dir, f"{split}-concocitabs-seq.jsonl")
        n_out = 0
        with codecs.open(path, "w", "utf-8") as f:
            for cocitedpids in copids_list:
                context_sents, citing_pids = sampled_contexts(cocitedpids)
                for i, j in itertools.combinations(range(len(cocitedpids)), 2):
                    anchor = pid2abstract[cocitedpids[i]]
                    pos = pid2abstract[cocitedpids[j]]
                    ex = {
                        "cited_pids": list(cocitedpids),
                        "query": {"TITLE": anchor["title"],
                                  "ABSTRACT": anchor["abstract"]},
                        "pos_context": {"TITLE": pos["title"],
                                        "ABSTRACT": pos["abstract"],
                                        "citing_contexts": context_sents,
                                        "citing_pids": citing_pids},
                    }
                    if split == "dev":
                        # negatives come FROM a co-cite set so they carry
                        # their own contexts (reference :672-684)
                        neg_copids = rng.choice(all_cocits)
                        neg_sents, neg_cpids = sampled_contexts(neg_copids)
                        neg = pid2abstract[rng.choice(list(neg_copids))]
                        ex["neg_context"] = {"TITLE": neg["title"],
                                             "ABSTRACT": neg["abstract"],
                                             "citing_contexts": neg_sents,
                                             "citing_pids": neg_cpids}
                    f.write(json.dumps(ex) + "\n")
                    n_out += 1
                if n_out > limits[split]:
                    break
        counts[split] = n_out
    return counts


def generate_examples_ict(pid2abstract: dict, out_dir: str, n_examples: int,
                          redact_prob: float = 0.9, seed: int = 57395) -> int:
    """Inverse-cloze-task pairs: a sentence vs its (usually redacted)
    abstract (pre_proc_cocits.py:321-375)."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    pids = list(pid2abstract.keys())
    path = os.path.join(out_dir, "train-ict.jsonl")
    n_out = 0
    with codecs.open(path, "w", "utf-8") as f:
        while n_out < n_examples:
            pid = rng.choice(pids)
            abstract = pid2abstract[pid]["abstract"]
            if len(abstract) < 2:
                continue
            si = rng.randrange(len(abstract))
            sent = abstract[si]
            if rng.random() < redact_prob:
                context = abstract[:si] + abstract[si + 1:]
            else:
                context = list(abstract)
            ex = {"query": {"TITLE": "", "ABSTRACT": [sent]},
                  "pos_context": {"TITLE": pid2abstract[pid]["title"],
                                  "ABSTRACT": context}}
            f.write(json.dumps(ex) + "\n")
            n_out += 1
    return n_out


# ----------------------------------------------------------------------
# Eval dataset converters -> common file layout.
def scidocs_to_common(in_path: str, out_path: str, dataset_name: str) -> dict:
    """SciDocs qrels -> common format (pre_proc_scidocs.py:17-122)."""
    with codecs.open(os.path.join(in_path, "paper_metadata_view_cite_read.json"),
                     "r", "utf-8") as f:
        pid2data = json.load(f)
    qpids2pool = collections.defaultdict(list)
    dev_q, test_q = set(), set()
    allpids = {}
    for split, fname in (("val", "val.qrel"), ("test", "test.qrel")):
        with codecs.open(os.path.join(in_path, dataset_name, fname), "r", "utf-8") as f:
            for line in f:
                qpid, _, cand, rel = line.strip().split()
                for pid in (qpid, cand):
                    d = pid2data.get(pid)
                    if not d or not d.get("abstract") or not d.get("title"):
                        break
                else:
                    allpids[qpid] = pid2data[qpid]
                    allpids[cand] = pid2data[cand]
                    qpids2pool[qpid].append((cand, int(rel)))
                    (dev_q if split == "val" else test_q).add(qpid)
    os.makedirs(out_path, exist_ok=True)
    name = f"scid{dataset_name}"
    with codecs.open(os.path.join(out_path, f"{name}-evaluation_splits.json"),
                     "w", "utf-8") as f:
        json.dump({"dev": sorted(dev_q), "test": sorted(test_q)}, f)
    pid2abstract = {}
    with codecs.open(os.path.join(out_path, f"abstracts-{name}.jsonl"), "w", "utf-8") as f:
        for pid, d in allpids.items():
            sents = sentencize(d["abstract"])
            if not sents:
                continue
            doc = {"title": d["title"], "abstract": sents, "paper_id": pid,
                   "metadata": {"year": d.get("year")}}
            pid2abstract[pid] = doc
            f.write(json.dumps(doc) + "\n")
    anns = {}
    with codecs.open(os.path.join(out_path, f"{name}-queries-release.csv"),
                     "w", "utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["paper_id", "title"], extrasaction="ignore")
        w.writeheader()
        for qpid, pool in qpids2pool.items():
            if qpid not in pid2abstract:
                continue
            cands = [c for c, _ in pool if c in pid2abstract]
            rels = [r for c, r in pool if c in pid2abstract]
            if cands:
                anns[qpid] = {"cands": cands, "relevance_adju": rels}
                w.writerow({"paper_id": qpid, "title": pid2abstract[qpid]["title"]})
    with codecs.open(os.path.join(out_path, f"test-pid2anns-{name}.json"), "w") as f:
        json.dump(anns, f)
    return {"queries": len(anns), "papers": len(pid2abstract)}


def relish_to_common(in_abs_path: str, in_ann_path: str, out_path: str,
                     split_seed: int = 582) -> dict:
    """RELISH -> common format (pre_proc_relish.py:44-206).

    in_abs_path: dir of PubMed-<pmid>.txt files (title line + abstract lines).
    in_ann_path: dir containing RELISH_v1_ann.json.
    Relevance: relevant=2, partial=1, irrelevant=0; 50/50 dev/test query split.
    """
    os.makedirs(out_path, exist_ok=True)
    pid2abstract = {}
    with codecs.open(os.path.join(out_path, "abstracts-relish.jsonl"), "w", "utf-8") as out:
        for fname in sorted(os.listdir(in_abs_path)):
            if not fname.endswith(".txt"):
                continue
            with codecs.open(os.path.join(in_abs_path, fname), "r", "utf-8") as f:
                lines = f.readlines()
            title = lines[0].strip()
            sents = sentencize(" ".join(s.strip() for s in lines[1:]))
            if title and sents:
                pmid = fname[len("PubMed-"):-len(".txt")]
                doc = {"title": title, "abstract": sents, "paper_id": pmid}
                pid2abstract[pmid] = doc
                out.write(json.dumps(doc) + "\n")
    with codecs.open(os.path.join(in_ann_path, "RELISH_v1_ann.json"), "r", "utf-8") as f:
        ann_dicts = json.load(f)
    anns = {}
    with codecs.open(os.path.join(out_path, "relish-queries-release.csv"), "w", "utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["paper_id", "title"], extrasaction="ignore")
        w.writeheader()
        for ann in ann_dicts:
            qpid = ann["pmid"]
            if qpid not in pid2abstract:
                continue
            cands, rels = [], []
            for grade, key in ((2, "relevant"), (1, "partial"), (0, "irrelevant")):
                for cpid in ann["response"][key]:
                    if cpid in pid2abstract and cpid not in cands:
                        cands.append(cpid)
                        rels.append(grade)
            if cands:
                anns[qpid] = {"cands": cands, "relevance_adju": rels}
                w.writerow({"paper_id": qpid, "title": pid2abstract[qpid]["title"]})
    with codecs.open(os.path.join(out_path, "test-pid2anns-relish.json"), "w") as f:
        json.dump(anns, f)
    qs = sorted(anns.keys())
    rng = random.Random(split_seed)
    rng.shuffle(qs)
    half = len(qs) // 2
    with codecs.open(os.path.join(out_path, "relish-evaluation_splits.json"), "w") as f:
        json.dump({"dev": qs[:half], "test": qs[half:]}, f)
    return {"queries": len(anns), "papers": len(pid2abstract)}


# pandas.read_csv's default missing-value markers (its `na_values`)
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _read_metadata_csv(path: str):
    """Rows of a CSV as dicts, as `pd.read_csv(path, on_bad_lines="skip")`
    gives them to the JAX package: a row with more fields than the header is
    skipped, a shorter one is padded with missing values, blank lines are
    skipped, and a missing value (an empty cell or one of pandas' NA
    markers) is None -- not a string, as pandas' NaN is not."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        for fields in reader:
            if not fields or len(fields) > len(header):
                continue
            fields = fields + [""] * (len(header) - len(fields))
            yield {name: (None if value in _NA_VALUES else value)
                   for name, value in zip(header, fields)}


def treccovid_to_common(in_path: str, out_path: str, max_queries_per_topic: int = 50,
                        pool_seed: int = 472945, split_seed: int = 582) -> dict:
    """TREC-COVID -> TRECCOVID-RF reformulation (pre_proc_treccovid.py:111-290).

    Judgement-2 docs per topic form the corpus; each of <= 50 sampled
    relevant docs per topic becomes a query whose positives are same-topic
    relevant docs (grade 2) and negatives the other topics' relevant docs
    (grade 0).  Topic-level 50/50 dev/test split.
    """
    os.makedirs(out_path, exist_ok=True)
    rng = random.Random(pool_seed)
    topic2pool = collections.defaultdict(list)
    with codecs.open(os.path.join(in_path, "qrels-covid_d5_j0.5-5.txt"), "r", "utf-8") as f:
        for line in f:
            topic_id, _, doc_id, judgement = line.strip().split()[:4]
            if judgement == "2":
                topic2pool[topic_id].append(doc_id)
    all_docs = {d for pool in topic2pool.values() for d in pool}
    pid2abstract = {}
    with codecs.open(os.path.join(out_path, "abstracts-treccovid.jsonl"), "w", "utf-8") as out:
        for row in _read_metadata_csv(
                os.path.join(in_path, "metadata-2021-06-21.csv")):
            doc_id = row.get("cord_uid")
            if doc_id not in all_docs:
                continue
            title, abs_text = row.get("title"), row.get("abstract")
            if not (isinstance(title, str) and isinstance(abs_text, str)) \
                    or doc_id in pid2abstract:
                continue
            sents = sentencize(abs_text)
            if not sents:
                continue
            doc = {"title": title, "abstract": sents, "paper_id": doc_id}
            pid2abstract[doc_id] = doc
            out.write(json.dumps(doc) + "\n")
    anns = {}
    qtopic = {}
    for topic, pool in sorted(topic2pool.items()):
        pool = [d for d in dict.fromkeys(pool) if d in pid2abstract]
        queries = pool if len(pool) <= max_queries_per_topic else \
            rng.sample(pool, max_queries_per_topic)
        negs = [d for t, p in sorted(topic2pool.items()) if t != topic
                for d in p if d in pid2abstract]
        for q in queries:
            cands = [d for d in pool if d != q]
            rels = [2] * len(cands)
            seen = set(cands) | {q}
            for d in negs:
                if d not in seen:
                    cands.append(d)
                    rels.append(0)
                    seen.add(d)
            if cands:
                anns[q] = {"cands": cands, "relevance_adju": rels}
                qtopic[q] = topic
    with codecs.open(os.path.join(out_path, "test-pid2anns-treccovid.json"), "w") as f:
        json.dump(anns, f)
    with codecs.open(os.path.join(out_path, "treccovid-queries-release.csv"),
                     "w", "utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["paper_id", "title"], extrasaction="ignore")
        w.writeheader()
        for q in anns:
            w.writerow({"paper_id": q, "title": pid2abstract[q]["title"]})
    topics = sorted(set(qtopic.values()))
    srng = random.Random(split_seed)
    srng.shuffle(topics)
    half = len(topics) // 2
    dev_topics = set(topics[:half])
    splits = {"dev": [q for q, t in qtopic.items() if t in dev_topics],
              "test": [q for q, t in qtopic.items() if t not in dev_topics]}
    with codecs.open(os.path.join(out_path, "treccovid-evaluation_splits.json"), "w") as f:
        json.dump(splits, f)
    return {"queries": len(anns), "papers": len(pid2abstract),
            "topics": len(topics)}


# ----------------------------------------------------------------------
def _extra_aligner(extra: dict, device="cuda"):
    """Pop aligner_* keys from an --extra dict and build the sentence
    aligner: aligner_run_dir (+ aligner_tokenizer, optional aligner_model)
    selects a trained cosentbert/ictsentbert run (data.align), mirroring the
    reference's SentenceTransformer alignment encoder
    (pre_proc_cocits.py:447-455).  The encoder runs on `device`."""
    run_dir = extra.pop("aligner_run_dir", None)
    if not run_dir:
        return None
    from .align import trained_sent_aligner
    tok = extra.pop("aligner_tokenizer")
    name = extra.pop("aligner_model", "cosentbert")
    return trained_sent_aligner(run_dir, tok, model_name=name, device=device)


def main(args):
    """Run one `preprocess` action, print its counts as JSON and return them;
    `args.device` (default "cuda") is where an aligner encodes, and only the
    actions given one use it."""
    extra = json.loads(args.extra) if args.extra else {}
    device = getattr(args, "device", "cuda")
    if args.action == "scidocs":
        out = scidocs_to_common(args.in_path, args.out_path, **extra)
    elif args.action == "relish":
        out = relish_to_common(args.in_path, extra.pop("ann_path", args.in_path),
                               args.out_path, **extra)
    elif args.action == "treccovid":
        out = treccovid_to_common(args.in_path, args.out_path, **extra)
    elif args.action == "filter-cocits":
        import pickle
        with open(args.in_path, "rb") as f:
            cocits = pickle.load(f)
        filt = filter_cocitation_contexts(cocits)
        with open(args.out_path, "wb") as f:
            pickle.dump(filt, f)
        out = {"cocitations": len(filt)}
    elif args.action == "gorc":
        # end-to-end S2ORC pass: batch-file dir -> train/dev cocit jsonl
        from .corpus import run_gorc_pipeline
        aligner = _extra_aligner(extra, device)
        out = run_gorc_pipeline(args.in_path, args.out_path, aligner=aligner,
                                **extra)
    elif args.action == "regen-examples":
        # re-run example generation from an existing gorc pass's partials
        # with a (new) aligner -- the two-model supervision pipeline hook
        from .corpus import regenerate_examples
        aligner = _extra_aligner(extra, device)
        out = regenerate_examples(args.in_path, args.out_path,
                                  aligner=aligner, **extra)
    elif args.action == "cocit-examples":
        import pickle
        aligner = _extra_aligner(extra, device)
        variant = extra.pop("variant", "cocitabs")
        with open(args.in_path, "rb") as f:
            cocits = pickle.load(f)
        with open(extra.pop("abstracts"), "rb") as f:
            pid2abstract = pickle.load(f)
        if variant == "contexts":
            # cospecter-contexts training data (train_suffix
            # 'concocitabs-seq'); no aligner on this variant
            out = generate_examples_cocitabs_contexts(
                cocits, pid2abstract, args.out_path, **extra)
        else:
            out = generate_examples_cocitabs(cocits, pid2abstract,
                                             args.out_path, aligner=aligner,
                                             **extra)
    else:
        raise ValueError(args.action)
    print(json.dumps(out))
    return out
