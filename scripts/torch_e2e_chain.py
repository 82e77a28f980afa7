"""The port's two-model supervision chain, end to end through its CLI:
corpus -> sentence encoder -> aligned triples -> train -> index -> rank.

Every stage is `python -m aspire_tpu_torch ...` (or, from Python,
`aspire_tpu_torch.cli.main([...])` with the argument lists built here):

  1. `preprocess gorc`   -- a synthetic S2ORC-shaped corpus of batch files
     with topical structure (co-citations happen within a topic; abstracts
     share topic vocabulary) through the multi-process gorc pipeline: the
     co-citation partials, train/dev-cocitabs.jsonl and the cosentbert
     sentence pairs train/dev-coppsent.jsonl;
  2. `train` cosentbert on the sentence pairs (the aligner's encoder);
  3. `preprocess regen-examples` with that run as the aligner: the
     co-cited abstract triples with `cc_align` / `abs_align`;
  4. `train` sbalisentbienc (ts + ot losses) on the aligned triples;
  5. `build-index` over a held-out corpus and `rank` its query pools with an
     OT rerank, scored by MAP / NDCG%20 against the expected MAP of a random
     ranking (100 permutations on the same gold).

The corpus, tokenizer vocabulary, train configurations and evaluation
dataset are made as scripts/e2e_chain.py makes them (the same generator, the
same seed, the same files); this file is the port's own copy, so it imports
nothing of the JAX package.  Reference chain: pre_proc_gorc.py ->
pre_proc_cocits.py -> main_sentsim.py -> pre_proc_cocits.py (aligned) ->
main_fsim.py -> pre_proc_buildreps.py -> pp_gen_nearest.py -> ranking_eval.py.

Usage:
  python scripts/torch_e2e_chain.py --root /tmp/chain                # pilot corpus, BERT-base, one CUDA card
  python scripts/torch_e2e_chain.py --root /tmp/chain --steps 4      # each training cut to 4 optimizer steps
  python scripts/torch_e2e_chain.py --root /tmp/chain --device cpu --tiny --steps 2
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent

SCALES = {
    # topics, cited/topic, pairs/topic, citers/pair, corpus docs/topic,
    # queries/topic-sample, epochs, seq_len, micro, accum, tiny_bert
    "pilot": dict(topics=4, cited=12, pairs=20, citers=2, corpus_per_topic=12,
                  n_query_topics=4, epochs=2, seq_len=64, micro=4, accum=8,
                  tiny=True, es_check_every=16, lr=1e-3, warmup=8,
                  search_k=40, batch_files=8, sent_words=(4, 6),
                  abs_sents=(3, 4)),
    "full": dict(topics=50, cited=60, pairs=600, citers=2, corpus_per_topic=40,
                 n_query_topics=25, epochs=2, seq_len=128, micro=8, accum=32,
                 tiny=False, es_check_every=800, lr=1e-4, warmup=200,
                 search_k=500, batch_files=32, sent_words=(6, 10),
                 abs_sents=(4, 6)),
}

FUNCTION_WORDS = ("we study the of and for with using on a method results "
                  "data model approach analysis new propose show that this "
                  "work system is are in to from by our").split()

# example counts passed to the gorc pipeline: above any scale's corpus
TRIPLE_LIMITS = {"train_size": 2_000_000, "dev_size": 4000}


def topic_word(t: int, j: int) -> str:
    return f"t{t}w{j}"


def make_lexicon(topics: int, words_per_topic: int = 30):
    return {t: [topic_word(t, j) for j in range(words_per_topic)]
            for t in range(topics)}


def make_sentence(rng, lex_t, sent_words=(6, 10)):
    n = rng.randint(*sent_words)
    words = [rng.choice(lex_t) if rng.random() < 0.6
             else rng.choice(FUNCTION_WORDS) for _ in range(n)]
    # capitalized sentence start + attached period so the regex sentencizer
    # (preprocess.sentencize fallback) splits abstracts correctly
    words[0] = words[0].capitalize()
    return " ".join(words) + "."


def make_abstract_sents(rng, lex_t, sc=None) -> list[str]:
    sw = sc["sent_words"] if sc else (6, 10)
    n_sents = rng.randint(*(sc["abs_sents"] if sc else (4, 6)))
    return [make_sentence(rng, lex_t, sw) for _ in range(n_sents)]


def make_abstract(rng, lex_t, sc=None) -> str:
    return " ".join(make_abstract_sents(rng, lex_t, sc))


def cited_paper(rng, pid, t, lex, sc):
    return {"paper_id": pid, "title": f"paper about {topic_word(t, 0)} methods",
            "abstract": make_abstract(rng, lex[t], sc)}


def citing_paper(rng, pid, t, lex, bib: list[str], sc=None):
    text = (f"we build on the {rng.choice(lex[t])} systems [1] and [2] "
            f"for {rng.choice(lex[t])} {rng.choice(FUNCTION_WORDS)} tasks .")
    s1, s2 = text.index("[1]"), text.index("[2]")
    return {
        "paper_id": pid, "title": f"citing {topic_word(t, 1)} paper",
        "abstract": make_abstract(rng, lex[t], sc),
        "has_grobid": True,
        "grobid_parse": {
            "bib_entries": {"BIBREF0": {"links": bib[0]},
                            "BIBREF1": {"links": bib[1]}},
            "body_text": [{
                "text": text,
                "cite_spans": [
                    {"start": s1, "end": s1 + 3, "ref_id": "BIBREF0"},
                    {"start": s2, "end": s2 + 3, "ref_id": "BIBREF1"},
                ]}],
        },
    }


def write_tokenizer(tok_dir: pathlib.Path, lex: dict) -> None:
    """A local BertTokenizer directory whose vocab holds the corpus' words."""
    tok_dir.mkdir(parents=True, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "[", "]",
             "1", "2"] + FUNCTION_WORDS + [
        "paper", "about", "citing", "tasks", "systems", "build", "prior"]
    for words in lex.values():
        vocab.extend(words)
    (tok_dir / "vocab.txt").write_text("\n".join(dict.fromkeys(vocab)) + "\n")
    (tok_dir / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))


def write_data(root: pathlib.Path, sc: dict, seed: int = 0) -> dict:
    """The S2ORC-shaped batch files (root/s2orc), a local BertTokenizer
    vocabulary (root/tokenizer) and the evaluation dataset (root/eval: 'syn',
    gold relevance = topic identity; corpus-index.jsonl holds the corpus
    documents only).  Returns counts."""
    rng = random.Random(seed)
    lex = make_lexicon(sc["topics"])
    corpus_dir = root / "s2orc"
    corpus_dir.mkdir(parents=True, exist_ok=True)

    # ---- S2ORC-shaped batch files ----
    cited_pids = {t: [f"c{t}_{i}" for i in range(sc["cited"])]
                  for t in range(sc["topics"])}
    papers = []
    for t in range(sc["topics"]):
        for pid in cited_pids[t]:
            papers.append(cited_paper(rng, pid, t, lex, sc))
        pairs = set()
        while len(pairs) < sc["pairs"]:
            a, b = rng.sample(cited_pids[t], 2)
            pairs.add((min(a, b), max(a, b)))
        for pi, (a, b) in enumerate(sorted(pairs)):
            for ci in range(sc["citers"]):
                papers.append(citing_paper(
                    rng, f"p{t}_{pi}_{ci}", t, lex, [a, b], sc))
    rng.shuffle(papers)
    nb = sc["batch_files"]
    for b in range(nb):
        with gzip.open(corpus_dir / f"{b}.jsonl.gz", "wt") as f:
            for p in papers[b::nb]:
                f.write(json.dumps(p) + "\n")

    write_tokenizer(root / "tokenizer", lex)

    # ---- eval corpus + query pools (gold relevance = topic identity) ----
    eval_dir = root / "eval"
    eval_dir.mkdir(exist_ok=True)
    corpus_docs, anns = {}, {}
    for t in range(sc["topics"]):
        for i in range(sc["corpus_per_topic"]):
            pid = f"d{t}_{i}"
            corpus_docs[pid] = {
                "title": f"paper about {topic_word(t, 0)} methods",
                "abstract": make_abstract_sents(rng, lex[t], sc)}
    # fresh query docs per sampled topic (not present in the index)
    qtopics = rng.sample(range(sc["topics"]), sc["n_query_topics"])
    all_corpus_pids = sorted(corpus_docs)
    query_docs = {}
    for t in qtopics:
        qpid = f"q{t}"
        query_docs[qpid] = {
            "title": f"query about {topic_word(t, 0)} methods",
            "abstract": make_abstract_sents(rng, lex[t], sc)}
        anns[qpid] = {
            "cands": all_corpus_pids,
            "relevance_adju": [2 if p.startswith(f"d{t}_") else 0
                               for p in all_corpus_pids]}

    def clean(abstract):
        return [s if s.endswith(".") else s + " ." for s in abstract if s.strip()]
    with open(eval_dir / "abstracts-syn.jsonl", "w") as f:
        for pid, d in {**corpus_docs, **query_docs}.items():
            f.write(json.dumps({"paper_id": pid, "title": d["title"],
                                "abstract": clean(d["abstract"])}) + "\n")
    with open(eval_dir / "test-pid2anns-syn.json", "w") as f:
        json.dump(anns, f)
    qpids = sorted(anns)
    with open(eval_dir / "syn-evaluation_splits.json", "w") as f:
        json.dump({"dev": qpids[: len(qpids) // 2],
                   "test": qpids[len(qpids) // 2:]}, f)
    with open(eval_dir / "corpus-index.jsonl", "w") as f:
        for pid, d in corpus_docs.items():
            f.write(json.dumps({"paper_id": pid, "title": d["title"],
                                "abstract": clean(d["abstract"])}) + "\n")
    return {"papers": len(papers), "batch_files": nb,
            "corpus_docs": len(corpus_docs), "queries": len(anns)}


def write_configs(root: pathlib.Path, sc: dict, sent_examples: dict,
                  examples: dict, steps: int | None = None) -> None:
    """config-sentenc.json (cosentbert, the aligner's encoder) and config.json
    (sbalisentbienc, reference sbalisentbienc-misup-otstuni.json scaled
    down).  `steps` cuts each training run to that many optimizer steps of
    one epoch (train_size = steps x examples a step), with one dev check
    half-way; None trains the scale's epochs over every example."""
    sent_micro = max(8, sc["micro"])
    n_micro = max(1, sc["accum"] // sc["micro"])
    if steps:
        sent_train, doc_train, epochs = steps * sent_micro, steps * sc["accum"], 1
        sent_es, doc_es = max(1, steps // 2), max(1, steps * n_micro // 2)
    else:
        sent_train, doc_train, epochs = (sent_examples["train"],
                                         examples["train"], sc["epochs"])
        sent_es = doc_es = sc["es_check_every"]
    common = {"base-pt-layer": str(root / "tokenizer"), "update_rule": "adam",
              "learning_rate": sc["lr"], "num_warmup_steps": sc["warmup"],
              "decay_lr_every": 1, "lr_decay_method": "warmuplin",
              "decay_lr_by": 0.95, "fine_tune": True, "num_epochs": epochs}
    cfg = {
        "model_name": "sbalisentbienc", "score_aggregation": "l2wasserstein",
        "geoml_blur": 0.05, "geoml_scaling": 0.9, "sent_sm_temp": 5000.0,
        "train_suffix": "cocitabsalign",
        "abs_loss_prop": 0.0, "sent_loss_prop": 1.0, "sentsup_loss_prop": 1.0,
        "train_size": doc_train, "dev_size": examples["dev"],
        "batch_size": sc["micro"], "accumulated_batch_size": sc["accum"],
        "es_check_every": doc_es, **common,
    }
    (root / "config.json").write_text(json.dumps(cfg, indent=1))
    sent_cfg = {
        "model_name": "cosentbert", "score_aggregation": "l2max",
        "train_suffix": "coppsent", "train_size": sent_train,
        "dev_size": sent_examples["dev"], "batch_size": sent_micro,
        "accumulated_batch_size": -1, "es_check_every": sent_es, **common,
    }
    (root / "config-sentenc.json").write_text(json.dumps(sent_cfg, indent=1))


# ------------------------------------------------------------ stage commands
def gorc_argv(root, processes: int, device: str) -> list:
    """Stage 1: batch files -> partials, cocitabs triples, sentence pairs."""
    return ["preprocess", "gorc", "--in-path", str(root / "s2orc"),
            "--out-path", str(root / "triples"),
            "--extra", json.dumps({"processes": processes, **TRIPLE_LIMITS}),
            "--device", device]


def sentenc_argv(root, sc: dict, device: str) -> list:
    """Stage 2: cosentbert on the mined sentence pairs (reference
    main_sentsim.py train_model)."""
    args = ["train", "--config", str(root / "config-sentenc.json"),
            "--train", str(root / "triples" / "train-coppsent.jsonl"),
            "--dev", str(root / "triples" / "dev-coppsent.jsonl"),
            "--out", str(root / "run-sentenc"),
            "--tokenizer", str(root / "tokenizer"),
            "--seq-len", str(min(64, sc["seq_len"])), "--device", device]
    return args + (["--tiny"] if sc["tiny"] else [])


def align_argv(root, device: str) -> list:
    """Stage 3: the cocitabs triples regenerated with the trained sentence
    encoder as the aligner (reference pre_proc_cocits.py:447-455)."""
    return ["preprocess", "regen-examples",
            "--in-path", str(root / "triples"),
            "--out-path", str(root / "triples_enc"),
            "--extra", json.dumps({
                "aligner_run_dir": str(root / "run-sentenc"),
                "aligner_tokenizer": str(root / "tokenizer"),
                **TRIPLE_LIMITS}),
            "--device", device]


def train_argv(root, sc: dict, device: str) -> list:
    """Stage 4: sbalisentbienc on the aligned triples."""
    triples = root / "triples_enc"
    args = ["train", "--config", str(root / "config.json"),
            "--train", str(triples / "train-cocitabsalign.jsonl"),
            "--dev", str(triples / "dev-cocitabsalign.jsonl"),
            "--out", str(root / "run"),
            "--tokenizer", str(root / "tokenizer"),
            "--seq-len", str(sc["seq_len"]), "--device", device]
    return args + (["--tiny"] if sc["tiny"] else [])


def index_argv(root, device: str) -> list:
    """Stage 5a: the held-out corpus into a multi-vector index."""
    return ["build-index", "--corpus", str(root / "eval" / "corpus-index.jsonl"),
            "--out", str(root / "index"), "--run-dir", str(root / "run"),
            "--tokenizer", str(root / "tokenizer"), "--batch-size", "32",
            "--device", device]


def rank_argv(root, sc: dict, device: str) -> list:
    """Stage 5b: every query's pool ranked against the index, OT rerank."""
    return ["rank", "--index", str(root / "index"), "--dataset", "syn",
            "--dataset-dir", str(root / "eval"), "--model", "sbalisentbienc",
            "--run-dir", str(root / "run"),
            "--tokenizer", str(root / "tokenizer"),
            "--out", str(root / "ranked"), "--k", str(sc["search_k"]),
            "--rerank", "ot", "--ot-temp", "5000.0", "--device", device]


def score_ranking(root) -> dict:
    """MAP / NDCG%20 of the ranked pools a split, and the expected MAP of a
    random ranking of the same pools (100 seeded permutations)."""
    sys.path.insert(0, str(REPO))
    from aspire_tpu_torch.evaluation.datasets import EvalDataset
    from aspire_tpu_torch.evaluation.protocols import (per_query_metrics,
                                                       ranked_relevances)
    from aspire_tpu_torch.evaluation.ranking_eval import eval_pool_ranking
    eval_dir = str(root / "eval")
    results = eval_pool_ranking(str(root / "ranked"), "syn", "sbalisentbienc",
                                dataset_dir=eval_dir)
    ds = EvalDataset("syn", eval_dir)
    gold = ds.get_gold_test_data()
    rnd = random.Random(7)
    rand_maps = []
    for _ in range(100):
        ranked = {q: [(c, 0.0) for c in rnd.sample(list(g), len(g))]
                  for q, g in gold.items()}
        rels = ranked_relevances(ranked, gold)
        qm = per_query_metrics(rels, threshold_grade=ds.get_threshold_grade())
        rand_maps.append(float(np.mean([m["av_precision"]
                                        for m in qm.values()])))
    return {"map": {s: r["mean_av_precision"] for s, r in results.items()},
            "ndcg%20": {s: r["ndcg%20"] for s, r in results.items()},
            "random_map": float(np.mean(rand_maps))}


def train_losses(run_dir) -> list:
    """(iter, loss) of every train_loss record in a run's metrics.jsonl."""
    out = []
    with open(pathlib.Path(run_dir) / "metrics.jsonl") as f:
        for line in f:
            m = json.loads(line)
            if m.get("kind") == "train_loss":
                out.append((m["iter"], m["loss"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--scale", choices=list(SCALES), default="pilot")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="BertConfig.tiny() encoders (default: BERT-base)")
    ap.add_argument("--steps", type=int, default=None,
                    help="cut each training run to this many optimizer steps")
    args = ap.parse_args()
    root = pathlib.Path(args.root)
    # the doc model reads 128 tokens (the tiny encoder's positions stop at
    # 64); the sentence encoder at most 64
    sc = dict(SCALES[args.scale], tiny=args.tiny, seq_len=64 if args.tiny else 128)
    env = {**os.environ, "PYTHONPATH": str(REPO)}

    def run(argv):
        t0 = time.time()
        subprocess.run([sys.executable, "-m", "aspire_tpu_torch", *argv],
                       check=True, cwd=str(REPO), env=env)
        print(f"[chain] {argv[0]} {argv[1]}: {time.time() - t0:.1f}s",
              flush=True)

    print("[chain] data:", write_data(root, sc), flush=True)
    run(gorc_argv(root, min(8, sc["batch_files"]), args.device))
    summary = json.loads((root / "triples" / "gorc-summary.json").read_text())
    write_configs(root, sc, summary["sent_examples"], summary["examples"],
                  args.steps)
    for argv in (sentenc_argv(root, sc, args.device),
                 align_argv(root, args.device),
                 train_argv(root, sc, args.device),
                 index_argv(root, args.device),
                 rank_argv(root, sc, args.device)):
        run(argv)
    out = {**score_ranking(root), "losses": train_losses(root / "run")}
    (root / "chain-summary.json").write_text(json.dumps(out, indent=1))
    print("[chain] summary:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
