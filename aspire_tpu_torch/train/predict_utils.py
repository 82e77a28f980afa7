"""Dev-set evaluation helpers (counterpart of aspire_tpu/train/predict_utils.py,
after src/learning/predict_utils.py).

batched_loss: summed no-grad loss over a dev stream (the early-stop signal,
src/learning/predict_utils.py:12-83).  batched_f1: macro/binary F1 from
logits for classification-style dev scoring (:86-141, sklearn-based in the
reference)."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .trainer import tree_to_device


def batched_loss(model, batches: Iterator, rng: torch.Generator | None = None
                 ) -> float:
    """Sum of deterministic losses over a dev batch stream, summed on the
    model's device and read once."""
    device = next(model.parameters()).device
    total = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        for batch in batches:
            total += model.train_loss(tree_to_device(batch, device), rng,
                                      False).float()
    return float(total)


def batched_f1(predict_fn, batches: Iterator, average: str = "binary") -> float:
    """F1 over a labelled dev stream; predict_fn(batch) -> logits.

    Each batch dict must carry 'labels'."""
    from sklearn.metrics import f1_score

    preds, golds = [], []
    for batch in batches:
        logits = predict_fn(batch)
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().float().cpu().numpy()
        preds.extend(np.argmax(np.asarray(logits), axis=-1).tolist())
        golds.extend(np.asarray(batch["labels"]).tolist())
    return float(f1_score(golds, preds, average=average))
