"""Training-data readers (jsonl triples -> superbatches)."""
from .readers import read_jsonl, TripleStream, dev_batches
