"""Corpus-scale S2ORC preprocessing over many files and processes (the
port's copy of aspire_tpu/data/corpus.py; the same partials and files).

The per-paper functions live in gorc.py/preprocess.py; this module is the
missing orchestration layer that walks a DIRECTORY of S2ORC batch files with
a process pool -- the reference's DirIterator/DirMetaIterator +
mp.Pool.imap_unordered pattern (src/pre_process/pre_proc_gorc.py:58-148,
src/pre_process/data_utils.py:12-115) -- so a real S2ORC pass has a single
entry point (`python -m aspire_tpu_torch preprocess gorc ...`):

  stage 1 (parallel over batch files): filter to full-text papers, extract
      per-paper citation contexts, collect noise-filtered abstracts.  Each
      worker writes one partial pair (pid2citcontext-{batch}.jsonl +
      abstracts-{batch}.jsonl) -- workers communicate through files, exactly
      like the reference's per-batch partials, so nothing big is pickled.
  stage 2 (merge): concatenate context partials, optionally filter by area
      (pre_proc_gorc.py:546-586), group into co-citations
      (gorc.gather_cocitations) -> cocitpids2contexts-{area}.pickle.
  stage 3: filter contexts (preprocess.filter_cocitation_contexts) and emit
      train/dev-{suffix}.jsonl co-cited abstract examples
      (preprocess.generate_examples_cocitabs).

The pool uses the 'spawn' start method: the parent may hold a CUDA context
(an earlier stage, or the aligner), and a forked child of such a process
cannot use CUDA.  Workers touch no device.
"""
from __future__ import annotations

import codecs
import gzip
import json
import logging
import multiprocessing as mp
import os
import pathlib
import pickle

from . import gorc
from . import preprocess as pp

log = logging.getLogger(__name__)


def list_batch_files(corpus_dir: str) -> list[str]:
    """Sorted jsonl/.jsonl.gz batch files in a corpus directory."""
    root = pathlib.Path(corpus_dir)
    files = [p for p in root.iterdir()
             if p.name.endswith(".jsonl") or p.name.endswith(".jsonl.gz")]
    return [str(p) for p in sorted(files)]


def _open_batch(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return codecs.open(path, "r", "utf-8")


def _batch_tag(path: str) -> str:
    name = os.path.basename(path)
    for suf in (".jsonl.gz", ".jsonl"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def process_batch_file(args) -> dict:
    """Stage-1 worker: one batch file -> context + abstract partials.

    args: (in_path, out_dir).  Returns counts.  Module-level function so the
    'spawn' pool can pickle it.
    """
    in_path, out_dir = args
    tag = _batch_tag(in_path)
    ctx_path = os.path.join(out_dir, f"pid2citcontext-{tag}.jsonl")
    abs_path = os.path.join(out_dir, f"abstracts-{tag}.jsonl")
    n_papers = n_ctx = n_abs = 0
    with _open_batch(in_path) as f, \
            codecs.open(ctx_path, "w", "utf-8") as ctx_f, \
            codecs.open(abs_path, "w", "utf-8") as abs_f:
        for line in f:
            paper = json.loads(line)
            n_papers += 1
            pid = str(paper.get("paper_id"))
            # abstracts: every paper with a clean title+abstract contributes
            title = paper.get("title")
            abstract = paper.get("abstract")
            if isinstance(abstract, str):
                abstract = pp.sentencize(abstract)
            if title and abstract and not pp.exclude_abstract(abstract):
                abs_f.write(json.dumps(
                    {"paper_id": pid, "title": title,
                     "abstract": abstract}) + "\n")
                n_abs += 1
            # citation contexts: full-text papers only
            if gorc.filter_metadata([paper]):
                ctx = gorc.extract_citation_contexts(paper)
                if ctx:
                    ctx_f.write(json.dumps({pid: ctx}) + "\n")
                    n_ctx += 1
    return {"batch": tag, "papers": n_papers, "contexts": n_ctx,
            "abstracts": n_abs}


def run_gorc_pipeline(corpus_dir: str, out_dir: str, processes: int | None = None,
                      area: str | None = None, pid2area: dict | None = None,
                      train_size: int = 1_276_820, dev_size: int = 10_000,
                      aligner=None, suffix: str | None = None,
                      chunksize: int = 1) -> dict:
    """Directory of S2ORC batch files -> train/dev co-citation jsonl.

    One command for the whole reference chain filter_metadata ->
    get_citation_count_large -> gather_cocitations -> cocit_corpus_to_jsonl ->
    generate_examples (pre_proc_gorc.py + pre_proc_cocits.py).
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    batch_files = list_batch_files(corpus_dir)
    if not batch_files:
        raise FileNotFoundError(f"no .jsonl/.jsonl.gz batch files in {corpus_dir}")
    processes = processes or min(mp.cpu_count(), len(batch_files))

    # ---- stage 1: parallel per-batch extraction ----
    tasks = [(p, str(out)) for p in batch_files]
    stats = []
    if processes > 1:
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes=processes, maxtasksperchild=10_000) as pool:
            for res in pool.imap_unordered(process_batch_file, tasks,
                                           chunksize=chunksize):
                stats.append(res)
                log.info("batch %(batch)s: %(papers)d papers, "
                         "%(contexts)d context rows, %(abstracts)d abstracts",
                         res)
    else:  # in-process fallback (tiny corpora / tests)
        stats = [process_batch_file(t) for t in tasks]

    # ---- stage 2: merge contexts -> co-citations ----
    area_tag = area or "all"

    def context_lines():
        for p in batch_files:
            path = out / f"pid2citcontext-{_batch_tag(p)}.jsonl"
            with codecs.open(str(path), "r", "utf-8") as f:
                if pid2area is not None and area is not None:
                    yield from gorc.filter_area_citcontexts(f, pid2area, area)
                else:
                    yield from f

    cocited, single = gorc.gather_cocitations(context_lines())
    with open(out / f"cocitpids2contexts-{area_tag}.pickle", "wb") as f:
        pickle.dump(cocited, f)

    # ---- stage 3: filter + examples ----
    counts, n_abstracts, n_usable, sent_counts = _examples_from_partials(
        out, cocited, train_size=train_size, dev_size=dev_size,
        aligner=aligner, suffix=suffix)

    summary = {
        "batch_files": len(batch_files),
        "papers": sum(s["papers"] for s in stats),
        "context_rows": sum(s["contexts"] for s in stats),
        "abstracts": n_abstracts,
        "cocited_sets": len(cocited),
        "single_cited": len(single),
        "filtered_sets": n_usable,
        "examples": counts,
        "sent_examples": sent_counts,
    }
    with open(out / "gorc-summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _load_abstract_partials(partials_dir: pathlib.Path) -> dict:
    pid2abstract = {}
    for path in sorted(partials_dir.glob("abstracts-*.jsonl")):
        with codecs.open(str(path), "r", "utf-8") as f:
            for line in f:
                d = json.loads(line)
                pid2abstract[d["paper_id"]] = {"title": d["title"],
                                               "abstract": d["abstract"]}
    return pid2abstract


def _examples_from_partials(out: pathlib.Path, cocited: dict,
                            train_size: int, dev_size: int,
                            aligner=None, suffix: str | None = None,
                            example_dir: pathlib.Path | None = None):
    """Stage 3: filter co-citations, join abstracts, emit cocit-abstract
    triples AND cosentbert sentence-pair examples
    (pre_proc_cocits.py:179-318,378-537)."""
    pid2abstract = _load_abstract_partials(out)
    filtered = pp.filter_cocitation_contexts(cocited)
    # keep only co-citations whose papers all have usable abstracts
    # (reference cocit_corpus_to_jsonl joins on the gathered abstracts)
    usable = {pids: ctxs for pids, ctxs in filtered.items()
              if all(p in pid2abstract for p in pids)}
    dest = str(example_dir or out)
    counts = pp.generate_examples_cocitabs(
        usable, pid2abstract, dest, train_size=train_size,
        dev_size=dev_size, aligner=aligner, suffix=suffix)
    # sentence-paraphrase pairs from multi-context co-citations: the
    # cosentbert training data (generate_examples_sent_rand); emitted
    # unconditionally so the sent-encoder half of the two-model pipeline
    # trains from the same mining pass.  Source = the context-filtered sets
    # (reference filter_cocitation_sentences needs contexts only, not the
    # cited papers' abstracts, pre_proc_cocits.py:179-264)
    sent_counts = pp.generate_examples_sent_rand(filtered, dest)
    return counts, len(pid2abstract), len(usable), sent_counts


def regenerate_examples(partials_dir: str, example_dir: str,
                        area: str = "all", train_size: int = 1_276_820,
                        dev_size: int = 10_000, aligner=None,
                        suffix: str | None = None) -> dict:
    """Re-run example generation from an existing gorc pass's partials.

    Reads cocitpids2contexts-{area}.pickle + abstracts-*.jsonl partials from
    a previous run_gorc_pipeline out_dir and regenerates train/dev examples
    into `example_dir` -- the hook for swapping the sentence ALIGNER after
    training a sentence encoder on the same mining pass (the reference's
    two-model pipeline: pre_proc_cocits.py mines, sentsim trains, then
    generate_examples_aligned_cocitabs_rand aligns with the trained
    encoder, :378-537)."""
    src = pathlib.Path(partials_dir)
    with open(src / f"cocitpids2contexts-{area}.pickle", "rb") as f:
        cocited = pickle.load(f)
    dest = pathlib.Path(example_dir)
    dest.mkdir(parents=True, exist_ok=True)
    counts, n_abs, n_usable, sent_counts = _examples_from_partials(
        src, cocited, train_size=train_size, dev_size=dev_size,
        aligner=aligner, suffix=suffix, example_dir=dest)
    return {"abstracts": n_abs, "filtered_sets": n_usable,
            "examples": counts, "sent_examples": sent_counts}
