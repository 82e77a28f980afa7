"""Small sizes at which the cells run on the CPU (the program's plain
versions) within a test's time."""
import time

import torch

CONFIG = {"vocab_size": 200, "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "intermediate_size": 128,
          "max_position_embeddings": 64}
INDEX = {"docs": 300, "buckets": [4, 8], "sentences": {"mean": 4, "min": 2, "max": 8}}
ABSTRACTS = {"seq": 48, "sentences": {"mean": 3, "min": 2, "max": 5},
             "sentence_tokens": [4, 8]}
TRAFFIC = {
    "aspire-1m-b32": {"batch": 4, "k": 8, "index": INDEX, "distinct_batches": 2,
                      "check_batches": 2, "trace_calls": 2, **ABSTRACTS},
    "aspire-1m-b1": {"k": 8, "index": INDEX, "distinct_batches": 4,
                     "check_batches": 3, "trace_calls": 2},
    "aspire-pool-ot": {"bucket": {"docs": 200, "sentences": 6}, "batch": 2,
                       "query_sents": 5, "pool": 16, "pool_live_min": 12,
                       "distinct_batches": 2, "check_batches": 2, "trace_calls": 2},
    "cospecter-encode-b128": {"batch": 4, "distinct_batches": 2, "check_batches": 2,
                              "trace_calls": 2, **ABSTRACTS},
}
CELLS = sorted(TRAFFIC)


def overrides(cell: str) -> dict:
    return {"config": CONFIG, "traffic": TRAFFIC[cell]}


def run(cell: str, seed: int = 123, trace: bool = False, faults=None) -> dict:
    from portbench.lib.cell import run_cell
    return run_cell(cell, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(),
                    overrides=overrides(cell), faults=faults)
