"""BERT weights drawn from the seed: one flat float32 buffer on the device,
one `randn` call, with a fixed table of named slices.

Both sides read the same buffer: the harness copies each slice into the
program's module (`load_into`), the reference reads the slices as they are
(`views`).  Linear weights keep torch's [out, in] layout.  Entries are N(0,
0.02), as BERT's initialiser draws them, with the LayerNorm gains 1 + N(0,
0.02) and the bi-encoder's layer mix N(0, 0.5)."""
from __future__ import annotations

import math

import torch

from .gen import generator


def table(cfg: dict) -> list:
    """[(name, shape), ...] of a config's parameters, in buffer order."""
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    out = [("emb.word", (v, h)), ("emb.pos", (cfg["max_position_embeddings"], h)),
           ("emb.type", (cfg["type_vocab_size"], h)),
           ("emb.ln.w", (h,)), ("emb.ln.b", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"l{i}."
        out += [(p + "q.w", (h, h)), (p + "q.b", (h,)),
                (p + "k.w", (h, h)), (p + "k.b", (h,)),
                (p + "v.w", (h, h)), (p + "v.b", (h,)),
                (p + "ao.w", (h, h)), (p + "ao.b", (h,)),
                (p + "ln1.w", (h,)), (p + "ln1.b", (h,)),
                (p + "i.w", (f, h)), (p + "i.b", (f,)),
                (p + "o.w", (h, f)), (p + "o.b", (h,)),
                (p + "ln2.w", (h,)), (p + "ln2.b", (h,))]
    out.append(("mix", (cfg["num_hidden_layers"] + 1,)))
    return out


BERT_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
             "intermediate_size", "max_position_embeddings", "type_vocab_size",
             "layer_norm_eps", "hidden_dropout_prob", "attention_probs_dropout_prob")


def program_config(cfg: dict):
    """The program's `BertConfig` for a configuration file's sizes."""
    from aspire_tpu_torch.models.bert import BertConfig
    return BertConfig(**{k: cfg[k] for k in BERT_KEYS})


def draw(cfg: dict, seed: int, device) -> torch.Tensor:
    """The flat buffer of a config's weights for a seed."""
    tab = table(cfg)
    total = sum(math.prod(s) for _, s in tab)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device)
    flat.mul_(0.02)
    for name, (lo, hi) in _offsets(tab).items():
        if name.endswith("ln.w") or name.endswith("ln1.w") or name.endswith("ln2.w"):
            flat[lo:hi].add_(1.0)
        elif name == "mix":
            flat[lo:hi].mul_(25.0)
    return flat


def views(flat: torch.Tensor, cfg: dict) -> dict:
    """name -> a view of its slice of the buffer, in its shape."""
    tab = table(cfg)
    offs = _offsets(tab)
    return {name: flat[offs[name][0]:offs[name][1]].view(shape)
            for name, shape in tab}


# the program's parameter names (models/bert.BertModel) for the table's
PROGRAM_NAMES = {
    "emb.word": "embeddings.word_embeddings.weight",
    "emb.pos": "embeddings.position_embeddings.weight",
    "emb.type": "embeddings.token_type_embeddings.weight",
    "emb.ln.w": "embeddings.LayerNorm.weight",
    "emb.ln.b": "embeddings.LayerNorm.bias",
}
LAYER_NAMES = {
    "q.w": "attention_self.query.weight", "q.b": "attention_self.query.bias",
    "k.w": "attention_self.key.weight", "k.b": "attention_self.key.bias",
    "v.w": "attention_self.value.weight", "v.b": "attention_self.value.bias",
    "ao.w": "attention_output_dense.weight", "ao.b": "attention_output_dense.bias",
    "ln1.w": "attention_output_LayerNorm.weight",
    "ln1.b": "attention_output_LayerNorm.bias",
    "i.w": "intermediate_dense.weight", "i.b": "intermediate_dense.bias",
    "o.w": "output_dense.weight", "o.b": "output_dense.bias",
    "ln2.w": "output_LayerNorm.weight", "ln2.b": "output_LayerNorm.bias",
}


def program_name(name: str) -> str:
    """The program's parameter name of a table entry (the layer mix is the
    bi-encoder's `layer_weights`; the rest lie under its `bert.`)."""
    if name == "mix":
        return "layer_weights"
    if name in PROGRAM_NAMES:
        return "bert." + PROGRAM_NAMES[name]
    layer, rest = name.split(".", 1)
    return f"bert.layer_{layer[1:]}.{LAYER_NAMES[rest]}"


@torch.no_grad()
def load_into(module: torch.nn.Module, flat: torch.Tensor, cfg: dict) -> None:
    """Copy the buffer into a ConSentEncoder's or BiEncoder's parameters."""
    params = dict(module.named_parameters())
    seen = set()
    for name, view in views(flat, cfg).items():
        target = program_name(name)
        if target not in params:
            continue                        # the mix, for ConSentEncoder
        params[target].copy_(view)
        seen.add(target)
    missing = set(params) - seen
    if missing:
        raise KeyError(f"parameters the weight table does not fill: {sorted(missing)}")


def _offsets(tab: list) -> dict:
    out, at = {}, 0
    for name, shape in tab:
        out[name] = (at, at + math.prod(shape))
        at += math.prod(shape)
    return out
