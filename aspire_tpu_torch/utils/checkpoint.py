"""Checkpoint restore for the port's own format (counterpart of
aspire_tpu/utils/checkpoint.py).

The port writes `model_{suffix}.pt`: a `state_dict` of CPU tensors, the
reference's own contract (trainer.py:53-92).  The JAX package writes orbax
trees, which cannot be read without JAX; weights cross between the packages
through models/convert.py over numpy trees.
"""
from __future__ import annotations

import torch


def restore_params(path) -> dict:
    """Restore a `model_{suffix}.pt` checkpoint as a state_dict of CPU
    tensors, whatever device it was saved from; the caller places it with
    `module.load_state_dict`."""
    return torch.load(str(path), map_location="cpu", weights_only=True)
