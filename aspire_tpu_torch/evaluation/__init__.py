from .metrics import compute_metrics
from .datasets import EvalDataset, FACETS
