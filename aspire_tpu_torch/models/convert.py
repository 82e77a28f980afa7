"""Carrying weights into the port (counterpart of aspire_tpu/models/convert.py).

Two sources, both as plain arrays, so that nothing here imports another
framework:

  * the Flax parameter tree of the JAX package as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)`` on the caller's side);
  * a Hugging Face BERT ``state_dict`` (tensor name -> tensor or ndarray).

The port's parameter names follow the Flax tree, so the first bridge is a
rename plus a transpose: dense ``kernel`` [in, out] -> ``weight`` [out, in],
LayerNorm ``scale`` -> ``weight``, ``embedding`` -> ``weight``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bert import BertConfig

_LEAF_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _t(arr) -> np.ndarray:
    """tensor/ndarray -> float32 numpy."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """An owned, contiguous float32 tensor (never a view of the source)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C", copy=True))


def state_dict_from_flax_params(params: dict,
                                config: BertConfig | None = None) -> dict:
    """Flax parameter tree (nested dicts of numpy arrays) -> port state_dict.

    Works for the trees of ConSentEncoder / ConSentSpanEncoder / BiEncoder
    (``{"bert": ..., ["layer_weights": ...]}``), BertModel and BertPooler.
    With a config, the number of ``layer_<i>`` subtrees is checked against it.
    """
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + [key])
                continue
            arr = _t(val)
            if key == "kernel":
                arr = arr.T
            name = ".".join(path + [_LEAF_RENAME.get(key, key)])
            out[name] = _tensor(arr)

    walk(params, [])
    if config is not None:
        layers = {k.split("layer_")[1].split(".")[0] for k in out
                  if "layer_" in k and "layer_weights" not in k}
        if layers and len(layers) != config.num_hidden_layers:
            raise ValueError(f"parameter tree has {len(layers)} layers, config "
                             f"has {config.num_hidden_layers}")
    return out


def state_dict_from_hf_state_dict(state_dict: dict, config: BertConfig,
                                  prefix: str = "") -> dict:
    """Map an HF BERT state_dict onto the port's BertModel state_dict.

    Accepts keys with or without the leading "bert." prefix.  `prefix` is put
    before every returned name ("bert." for the encoders that hold the model
    as ``self.bert``).  HF dense weights are already [out, in].
    """
    sd = {}
    for k, v in state_dict.items():
        sd[k.removeprefix("bert.").removeprefix("bert_encoder.")] = v

    out = {}

    def put(dst, src):
        for leaf in ("weight", "bias"):
            out[f"{prefix}{dst}.{leaf}"] = _tensor(_t(sd[f"{src}.{leaf}"]))

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = _tensor(
            _t(sd[f"embeddings.{name}.weight"]))
    put("embeddings.LayerNorm", "embeddings.LayerNorm")
    for i in range(config.num_hidden_layers):
        p, d = f"encoder.layer.{i}", f"layer_{i}"
        put(f"{d}.attention_self.query", f"{p}.attention.self.query")
        put(f"{d}.attention_self.key", f"{p}.attention.self.key")
        put(f"{d}.attention_self.value", f"{p}.attention.self.value")
        put(f"{d}.attention_output_dense", f"{p}.attention.output.dense")
        put(f"{d}.attention_output_LayerNorm", f"{p}.attention.output.LayerNorm")
        put(f"{d}.intermediate_dense", f"{p}.intermediate.dense")
        put(f"{d}.output_dense", f"{p}.output.dense")
        put(f"{d}.output_LayerNorm", f"{p}.output.LayerNorm")
    return out


def pooler_state_dict_from_hf_state_dict(state_dict: dict) -> dict | None:
    """Extract the BertPooler (`pooler_output` head) weights, if present.

    Checkpoints saved with `add_pooling_layer=False` (and the aspire
    encoders, which never use the pooler) lack the keys -> None."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    if "pooler.dense.weight" not in sd:
        return None
    return {"dense.weight": _tensor(_t(sd["pooler.dense.weight"])),
            "dense.bias": _tensor(_t(sd["pooler.dense.bias"]))}


def config_from_hf(hf_config) -> BertConfig:
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
    )


def state_dict_from_hf_model(hf_model, config: BertConfig | None = None,
                             prefix: str = "") -> dict:
    """Convert a live `transformers` BertModel (or model with .bert)."""
    if config is None:
        config = config_from_hf(hf_model.config)
    return state_dict_from_hf_state_dict(hf_model.state_dict(), config, prefix)
