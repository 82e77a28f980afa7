"""S2ORC (GORC) corpus mining: citation contexts -> co-citations (the port's
copy of aspire_tpu/data/gorc.py; host code, the same files).

Re-implements the contracts of src/pre_process/pre_proc_gorc.py as pure,
multiprocessing-friendly functions:

  * extract_citation_contexts -- per full-text paper: map linked bib entries
    to cited pids, sentencize body paragraphs, and record the sentence
    containing each citation span (:379-424)
  * gather_cocitations -- group citation contexts by (paragraph, sentence)
    position: papers cited in the SAME sentence are co-cited; merge across
    the corpus into {(cited pids): [(citing_pid, context_sentence)]}
    (:589-672)
  * cocit_corpus_to_examples glue lives in preprocess.py (filtering +
    example generation).

File contracts preserved: pid2citcontext-{area}.jsonl lines of
{citing_pid: {cited_pid: [[par_i, sent_i, sentence], ...]}}, and
cocitpids2contexts-{area}.pickle.
"""
from __future__ import annotations

import codecs
import collections
import json
import pickle

from .preprocess import sentencize, exclude_abstract


def _is_nan(value) -> bool:
    """Missing-value check matching pandas NaN semantics on S2ORC metadata
    TSVs: absent, None, empty string, or a float NaN."""
    if value is None or value == "":
        return True
    return isinstance(value, float) and value != value


def filter_metadata(meta_rows, require_fields=("abstract", "title"),
                    filter_nan_cols=None) -> list[dict]:
    """Filter S2ORC metadata records to full-text parsed papers.

    Mirrors pre_proc_gorc.py:25-89: keep rows whose ``has_grobid_text``
    column is true (`filter_for_fulltext`, :39 -- which ignores its
    filter-columns argument).  The opt-in `filter_nan_cols` behavior (drop
    rows with a missing/NaN value in any of those columns) mirrors the
    reference's `filter_by_hostingservice`/CS-filter path instead, where the
    NaN-column filtering actually runs.
    Rows carrying an inline ``grobid_parse`` (full-paper jsons rather than
    metadata TSV rows) or a truthy ``has_grobid`` are also accepted as
    full-text.  `require_fields` must additionally be present and non-empty.
    """
    out = []
    for row in meta_rows:
        has_fulltext = (bool(row.get("has_grobid_text"))
                        or bool(row.get("has_grobid"))
                        or bool(row.get("grobid_parse")))
        if not has_fulltext:
            continue
        if row.get("has_pdf_parse") is False:
            continue
        if any(not row.get(f) for f in require_fields):
            continue
        if filter_nan_cols and any(_is_nan(row.get(c)) for c in filter_nan_cols):
            continue
        out.append(row)
    return out


def extract_citation_contexts(paper_json: dict) -> dict:
    """One full-text paper -> {cited_pid: [(par_i, sent_i, sentence), ...]}.

    paper_json follows the S2ORC grobid parse schema: 'grobid_parse' with
    'bib_entries' ({bibid: {'links': pid}}) and 'body_text'
    ([{'text', 'cite_spans': [{'start','end','ref_id'}]}]).
    """
    parsed = paper_json.get("grobid_parse") or {}
    bib2pid = {bibid: bm["links"]
               for bibid, bm in (parsed.get("bib_entries") or {}).items()
               if bm.get("links")}
    if not bib2pid:
        return {}
    pid2citcontext = collections.defaultdict(list)
    for par_i, par_dict in enumerate(parsed.get("body_text") or []):
        par_text = par_dict.get("text") or ""
        par_sents = sentencize(par_text)
        for span in par_dict.get("cite_spans") or []:
            ref = span.get("ref_id")
            if not ref or ref not in bib2pid:
                continue
            span_text = par_text[span["start"]: span["end"]]
            pid = bib2pid[ref]
            for sent_i, sent in enumerate(par_sents):
                if span_text and span_text in sent:
                    pid2citcontext[pid].append((par_i, sent_i, sent))
    return dict(pid2citcontext)


def write_citation_contexts(papers, out_path: str) -> int:
    """Stream papers (dicts with 'paper_id') -> pid2citcontext jsonl."""
    n = 0
    with codecs.open(out_path, "w", "utf-8") as f:
        for paper in papers:
            ctx = extract_citation_contexts(paper)
            if ctx:
                f.write(json.dumps({paper["paper_id"]: ctx}) + "\n")
                n += 1
    return n


def gather_cocitations(citcontext_lines) -> tuple[dict, dict]:
    """Iterate pid2citcontext jsonl lines -> (cocited, single-cited) maps.

    Returns ({(sorted cited pids): [(citing_pid, sentence), ...]},
             {(pid,): [...]}) exactly like pre_proc_gorc.py:589-672.
    """
    cocited = collections.defaultdict(list)
    single = collections.defaultdict(list)
    for line in citcontext_lines:
        d = json.loads(line) if isinstance(line, str) else line
        citing_pid, cited2contexts = next(iter(d.items()))
        by_position = collections.defaultdict(list)
        for cited_pid, tuples in cited2contexts.items():
            for par_i, sent_i, sent in tuples:
                by_position[(par_i, sent_i)].append((cited_pid, sent))
        paper_cocits = collections.defaultdict(list)
        for group in by_position.values():
            sent = group[0][1]
            pids = sorted({t[0] for t in group})
            paper_cocits[tuple(pids)].append((citing_pid, sent))
        for pids, contexts in paper_cocits.items():
            (single if len(pids) == 1 else cocited)[pids].extend(contexts)
    return dict(cocited), dict(single)


def gather_cocitations_file(in_jsonl: str, out_pickle: str,
                            out_single_pickle: str | None = None) -> dict:
    with codecs.open(in_jsonl, "r", "utf-8") as f:
        cocited, single = gather_cocitations(f)
    with open(out_pickle, "wb") as f:
        pickle.dump(cocited, f)
    if out_single_pickle:
        with open(out_single_pickle, "wb") as f:
            pickle.dump(single, f)
    return {"cocited_sets": len(cocited), "single_cited": len(single)}


def gather_papers(pid_set: set, batch_files) -> dict:
    """Collect full-paper jsons for a pid set from S2ORC batch jsonl files
    (pre_proc_gorc.py:116-148).  batch_files: iterable of open files/paths."""
    out = {}
    for bf in batch_files:
        f = codecs.open(bf, "r", "utf-8") if isinstance(bf, str) else bf
        with f:
            for line in f:
                d = json.loads(line)
                pid = str(d.get("paper_id"))
                if pid in pid_set:
                    out[pid] = d
    return out


def filter_area_citcontexts(citcontext_lines, pid2area: dict,
                            area: str):
    """Keep citation-context lines whose citing paper belongs to `area`
    (pre_proc_gorc.py:546-586; areas: 'compsci'/'biomed' from metadata fields
    of study)."""
    for line in citcontext_lines:
        d = json.loads(line) if isinstance(line, str) else line
        citing_pid = next(iter(d))
        if pid2area.get(str(citing_pid)) == area:
            yield d


def filter_corpus_abstracts(papers) -> dict:
    """{pid: {'title', 'abstract'}} for papers passing the noise filter
    (pre_proc_gorc.py cocit_corpus_to_jsonl + exclude_abstract)."""
    out = {}
    for paper in papers:
        title = paper.get("title")
        abstract = paper.get("abstract")
        if isinstance(abstract, str):
            abstract = sentencize(abstract)
        if not title or not abstract or exclude_abstract(abstract):
            continue
        out[paper["paper_id"]] = {"title": title, "abstract": abstract}
    return out
