"""Entity-extraction sidecar: the {dataset}-ner.jsonl contract (the port's
copy of aspire_tpu/data/ner.py; spacy is imported only when asked for).

The reference extracts scientific entities with the external PURE scierc
model (src/pre_process/extract_entities.py) and stores them per sentence:
  {pid: [[entities of sent 0], [entities of sent 1], ...]}
consumed by the NER-augmented eval models (utils/models.py:211-233,607-734).

PURE isn't vendored here; `write_ner_file` takes any span-extractor callable
(sentence -> list of entity strings), so a scispacy pipeline, a PURE wrapper,
or a regex baseline can plug in.  `simple_entity_extractor` provides a
dependency-free baseline (capitalized/technical noun chunks) so the NER file
contract and the downstream faceted-entity code paths are fully exercisable
offline.
"""
from __future__ import annotations

import codecs
import json
import re
from typing import Callable


def simple_entity_extractor(sentence: str) -> list[str]:
    """Heuristic technical-term extractor (baseline, no ML deps).

    Grabs capitalized multi-word spans, hyphenated/alphanumeric technical
    tokens, and parenthesized acronyms.
    """
    ents = []
    # parenthesized acronyms: (BERT), (OT)
    ents += re.findall(r"\(([A-Z][A-Za-z0-9\-]{1,15})\)", sentence)
    # capitalized spans (skip sentence-initial single words)
    for m in re.finditer(r"(?<!^)(?<![.!?]\s)([A-Z][a-zA-Z0-9]+(?:[ -][A-Z][a-zA-Z0-9]+)+)",
                         sentence):
        ents.append(m.group(1))
    # hyphenated technical terms: co-citation, multi-vector
    ents += [m.group(0) for m in
             re.finditer(r"\b[a-z]+(?:-[a-z0-9]+){1,3}\b", sentence)
             if len(m.group(0)) > 7]
    seen, out = set(), []
    for e in ents:
        if e.lower() not in seen:
            seen.add(e.lower())
            out.append(e)
    return out


def scispacy_entity_extractor(model_name: str = "en_core_sci_sm",
                              labels: set[str] | None = None):
    """Build an extractor backed by a (sci)spacy NER pipeline.

    The reference extracts entities with the external PURE scierc model
    (src/pre_process/extract_entities.py:18-129); scispacy's scientific NER
    is the nearest stand-in that installs from pip.  Gated on availability:
    raises ImportError with guidance when spacy/the model is absent (neither
    is installed by default), so callers fall back to `simple_entity_extractor`.

    Returns sentence -> [entity strings], matching the per-sentence contract
    of extract_ner_spans (:103-129).
    """
    try:
        import spacy
    except ImportError as e:  # pragma: no cover - spacy not installed
        raise ImportError(
            "scispacy extractor needs `pip install spacy scispacy` and the "
            f"model {model_name!r}; use simple_entity_extractor offline") from e
    try:
        nlp = spacy.load(model_name)
    except OSError as e:  # pragma: no cover - model package missing
        # scispacy models install from scispacy's own URLs, not PyPI
        raise ImportError(
            f"spacy model {model_name!r} is not installed (scispacy models "
            "install via `pip install <scispacy model URL>`); use "
            "simple_entity_extractor offline") from e

    def extract(sentence: str) -> list[str]:
        doc = nlp(sentence)
        return [ent.text for ent in doc.ents
                if labels is None or ent.label_ in labels]

    return extract


def write_ner_file(abstracts_jsonl: str, out_path: str,
                   extractor: Callable[[str], list[str]] | None = None) -> int:
    """abstracts-{name}.jsonl -> {name}-ner.jsonl ({pid: per-sentence lists})."""
    extractor = extractor or simple_entity_extractor
    pid2ents = {}
    with codecs.open(abstracts_jsonl, "r", "utf-8") as f:
        for line in f:
            d = json.loads(line.strip())
            pid2ents[d["paper_id"]] = [extractor(s) for s in d["abstract"]]
    with codecs.open(out_path, "w", "utf-8") as f:
        json.dump(pid2ents, f)
    return len(pid2ents)
