"""Carrying weights into the port and back (counterpart of
aspire_tpu/models/convert.py).

Two sources, both as plain arrays, so that nothing here imports another
framework:

  * the Flax parameter tree of the JAX package as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)`` on the caller's side);
  * a Hugging Face BERT ``state_dict`` (tensor name -> tensor or ndarray),
    or a whole local HF model directory read without `transformers`
    (`load_hf_dir`: config.json, pytorch_model.bin or model.safetensors,
    vocab.txt and tokenizer_config.json).

The port's parameter names follow the Flax tree, so the first bridge is a
rename plus a transpose: dense ``kernel`` [in, out] -> ``weight`` [out, in],
LayerNorm ``scale`` -> ``weight``, ``embedding`` -> ``weight``.  A whole
doc or sentence model holds its encoder as ``self.encoder`` (``ICTModel``: its
towers as ``sent_encoder`` / ``context_encoder``), which the ``model_*``
functions add and strip.  ``flax_params_from_state_dict`` is the way back, so
that trained weights -- and gradients, through the same renaming -- can be
handed to the JAX model and compared.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import types

import numpy as np
import torch

from ..core.types import require_device
from .bert import BertConfig, BertModel

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
                                config: BertConfig | None = None,
                                prefix: str = "") -> dict:
    """Flax parameter tree (nested dicts of numpy arrays) -> port state_dict.

    Works for the trees of ConSentEncoder / ConSentSpanEncoder / BiEncoder
    (``{"bert": ..., ["layer_weights": ...]}``), BertModel, BertPooler,
    FeedForwardNet and GatedAttention.  With a config, the number of
    ``layer_<i>`` subtrees is checked against it.  `prefix` is put before
    every name.
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
            out[prefix + name] = _tensor(arr)

    walk(params, [])
    if config is not None:
        layers = {k.split("layer_")[1].split(".")[0] for k in out
                  if "layer_" in k and "layer_weights" not in k}
        if layers and len(layers) != config.num_hidden_layers:
            raise ValueError(f"parameter tree has {len(layers)} layers, config "
                             f"has {config.num_hidden_layers}")
    return out


def flax_params_from_state_dict(state_dict: dict, prefix: str = "") -> dict:
    """Port state_dict (or any name -> tensor/ndarray mapping with the same
    names, such as gradients) -> Flax-layout nested dict of numpy arrays: the
    inverse of `state_dict_from_flax_params`.  Names not starting with
    `prefix` are left out."""
    tree: dict = {}
    for name, val in state_dict.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split(".")
        arr = _t(val)
        if leaf == "weight":
            if path and path[-1].endswith("_embeddings"):
                leaf = "embedding"
            elif arr.ndim == 1:
                leaf = "scale"
            else:
                leaf, arr = "kernel", arr.T
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, dtype=np.float32, order="C", copy=True)
    return tree


# top-level Flax subtree -> attribute holding it in the port's model
_ICT_TOWERS = {"sent": "sent_encoder", "context": "context_encoder"}


def model_state_dict_from_flax_params(params: dict, model_name: str,
                                      config: BertConfig | None = None) -> dict:
    """The Flax tree of a whole model (`model.init_params(...)` of
    aspire_tpu's doc_models / sent_models) -> the state_dict of the port's
    model of the same registry name."""
    if model_name == "ictsentbert":
        out = {}
        for tower, attr in _ICT_TOWERS.items():
            out.update(state_dict_from_flax_params(params[tower], config,
                                                   prefix=attr + "."))
        return out
    return state_dict_from_flax_params(params, config, prefix="encoder.")


def flax_params_from_model_state_dict(state_dict: dict, model_name: str) -> dict:
    """The way back: a port model's state_dict (or its gradients under the
    same names) -> the Flax tree `train_loss(params, ...)` of the JAX model
    takes."""
    if model_name == "ictsentbert":
        return {tower: flax_params_from_state_dict(state_dict, attr + ".")
                for tower, attr in _ICT_TOWERS.items()}
    return flax_params_from_state_dict(state_dict, "encoder.")


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


# safetensors dtype names -> numpy dtypes (BF16 is widened by hand)
_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "I64": np.int64, "I32": np.int32, "I16": np.int16,
                       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path) -> dict:
    """A ``.safetensors`` file as name -> float32/int numpy array, parsed by
    hand: an 8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets}}, then the raw little-endian data."""
    raw = pathlib.Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf = raw[base + begin:base + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << np.uint32(16)
            arr = bits.view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(buf, np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
                                .newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which is not read here")
        out[name] = arr.reshape(shape).copy()
    return out


def read_hf_config(path) -> dict:
    """config.json of a local HF model directory, as a dict."""
    with open(pathlib.Path(path) / "config.json") as f:
        return json.load(f)


def _hf_weights(path: pathlib.Path) -> dict:
    """The directory's weights (model.safetensors first, as HF prefers it,
    else pytorch_model.bin), with the old LayerNorm names gamma/beta
    renamed to weight/bias as `from_pretrained` renames them."""
    if (path / "model.safetensors").exists():
        sd = read_safetensors(path / "model.safetensors")
    elif (path / "pytorch_model.bin").exists():
        sd = torch.load(path / "pytorch_model.bin", map_location="cpu",
                        weights_only=True)
    else:
        raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                                "pytorch_model.bin")
    out = {}
    for k, v in sd.items():
        if k.endswith("LayerNorm.gamma"):
            k = k[:-len("gamma")] + "weight"
        elif k.endswith("LayerNorm.beta"):
            k = k[:-len("beta")] + "bias"
        out[k] = v
    return out


# model_type -> what the port builds from such a directory
HF_FAMILIES = ("bert", "roberta", "mpnet")


@dataclasses.dataclass
class HFDir:
    """A local HF model directory (BERT, RoBERTa or MPNet), read without
    `transformers`."""

    config: object               # BertConfig; mpnet.MPNetConfig for MPNet
    hf_state_dict: dict          # the file's tensors, HF names, on the CPU
    tokenizer: object            # text.fast.FastWordPiece; text.bpe.ByteLevelBPE
    device: torch.device
    model_type: str = "bert"
    padding_idx: int = 1         # RoBERTa's position ids count past it

    def bert_state_dict(self, prefix: str = "") -> dict:
        """The port's BertModel state_dict (`prefix` before every name:
        "bert." for the encoders that hold the model as ``self.bert``)."""
        if self.model_type == "mpnet":
            raise ValueError("an MPNet directory has no BertModel weights: "
                             "use encoder_model()")
        return state_dict_from_hf_state_dict(self.hf_state_dict, self.config,
                                             prefix)

    def pooler_state_dict(self) -> dict | None:
        return pooler_state_dict_from_hf_state_dict(self.hf_state_dict)

    def encoder_model(self, attention_impl: str = "auto",
                      ffn_impl: str = "auto"):
        """The directory's encoder in f32 on its device, in eval mode, its
        weights loaded: a BertModel, a RobertaModel (position ids past the
        padding id) or an MPNetModel.  Each returns (last hidden state,
        hidden states).  MPNet's attention is its own (no attention_impl)."""
        if self.model_type == "mpnet":
            from .mpnet import MPNetModel
            model = MPNetModel(self.config, ffn_impl=ffn_impl,
                               device=self.device)
            model.load_state_dict(mpnet_state_dict_from_hf_state_dict(
                self.hf_state_dict))
            return model.eval()
        kw = dict(attention_impl=attention_impl, ffn_impl=ffn_impl,
                  device=self.device)
        if self.model_type == "roberta":
            from .bert import RobertaModel
            model = RobertaModel(self.config, padding_idx=self.padding_idx, **kw)
        else:
            model = BertModel(self.config, **kw)
        model.load_state_dict(self.bert_state_dict())
        return model.eval()


def mpnet_state_dict_from_hf_state_dict(state_dict: dict) -> dict:
    """An HF MPNetModel state_dict (with or without the "mpnet." prefix) ->
    the port's MPNetModel state_dict: the same names, without the pooler and
    the position_ids buffer."""
    out = {}
    for k, v in state_dict.items():
        k = k.removeprefix("mpnet.")
        if k.startswith(("embeddings.", "encoder.")) and not k.endswith("position_ids"):
            out[k] = _tensor(_t(v))
    return out


def load_hf_dir(path, device="cuda") -> HFDir:
    """Read a local HF directory as AutoModel / AutoTokenizer
    `from_pretrained` would, for the model types of HF_FAMILIES:

    * ``bert``: config.json -> BertConfig, vocab.txt + tokenizer_config.json
      -> the port's FastWordPiece;
    * ``roberta``: BertConfig (type_vocab_size 1, LayerNorm eps 1e-5 from
      its config), vocab.json + merges.txt -> text.bpe.ByteLevelBPE;
    * ``mpnet``: mpnet.MPNetConfig, a WordPiece vocab.txt with <s> </s>
      <pad> <mask> as its special tokens;

    the weights from model.safetensors or pytorch_model.bin (with or without
    a "bert." / "roberta." / "mpnet." prefix, with or without a pooler).
    Other model types are refused by name.  `device`: where the modules
    built from it go (a CUDA request without CUDA raises here)."""
    from ..text.fast import FastWordPiece
    dev = require_device(device)
    path = pathlib.Path(path)
    raw = read_hf_config(path)
    model_type = raw.get("model_type", "bert")
    if model_type not in HF_FAMILIES:
        raise ValueError(f"{path} holds a {model_type!r} model; the port "
                         f"encodes the families {HF_FAMILIES} only")
    weights = _hf_weights(path)
    if model_type == "mpnet":
        from .mpnet import MPNetConfig
        return HFDir(config=MPNetConfig.from_hf(raw), hf_state_dict=weights,
                     tokenizer=FastWordPiece.from_dir(str(path)), device=dev,
                     model_type=model_type)
    if model_type == "roberta":
        from ..text.bpe import ByteLevelBPE
        tokenizer = ByteLevelBPE.from_dir(str(path))
        weights = {k.removeprefix("roberta."): v for k, v in weights.items()}
    else:
        tokenizer = FastWordPiece.from_dir(str(path))
    config = config_from_hf(types.SimpleNamespace(**{
        "type_vocab_size": 2, "layer_norm_eps": 1e-12, **raw}))
    return HFDir(config=config, hf_state_dict=weights, tokenizer=tokenizer,
                 device=dev, model_type=model_type,
                 padding_idx=raw.get("pad_token_id", 1))
