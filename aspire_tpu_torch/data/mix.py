"""Training-mix sampling (scripts/sample_merge_s2orcscidocs.sh equivalent);
the port's copy of aspire_tpu/data/mix.py, with the same seeded RNG streams.

The reference builds the s2orcscidocs training mix by shuf/head-ing 40%
compsci + 60% biomed triples (scripts/sample_merge_s2orcscidocs.sh:22-44).
`sample_merge` does the same with a seeded RNG, plus per-epoch reshuffling
(run_main_fsim-ddp.sh shuffles the training jsonl before every epoch).
"""
from __future__ import annotations

import codecs
import random


def sample_merge(inputs: list[tuple[str, int]], out_path: str,
                 seed: int = 69306) -> int:
    """Sample `count` lines from each (path, count) input, shuffle, write."""
    rng = random.Random(seed)
    pool: list[str] = []
    for path, count in inputs:
        with codecs.open(path, "r", "utf-8") as f:
            lines = [l for l in f if l.strip()]
        rng.shuffle(lines)
        pool.extend(lines[:count])
    rng.shuffle(pool)
    with codecs.open(out_path, "w", "utf-8") as f:
        f.writelines(pool)
    return len(pool)


def shuffle_file(path: str, out_path: str, seed: int) -> int:
    """Seeded whole-file shuffle (per-epoch `shuf` replacement)."""
    with codecs.open(path, "r", "utf-8") as f:
        lines = [l for l in f if l.strip()]
    random.Random(seed).shuffle(lines)
    with codecs.open(out_path, "w", "utf-8") as f:
        f.writelines(lines)
    return len(lines)
