"""Example: tsAspire contextual-sentence encoding + single-match scoring, on
the PyTorch/CUDA port (aspire_tpu_torch).

The port's twin of ex_consent.py: encode a pair of abstracts into
per-sentence multi-vectors and score them with the masked all-pair L2
max-sim (tsAspire).  It prints the same lines as ex_consent.py.

Pass a LOCAL Hugging Face checkpoint directory (config.json, pytorch_model.bin
or model.safetensors, vocab.txt), e.g. a download of
allenai/aspire-contextualsentence-singlem-compsci, as --weights-dir; it is
read without `transformers`.  With no weights dir the example runs a random
tiny encoder (BertConfig.tiny(), weights from a seeded torch.Generator, a
vocab of the example's words).  It runs on the GPU unless --device cpu:

    python examples/ex_consent_torch.py [--weights-dir DIR] [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from aspire_tpu_torch.core.types import MultiVec, require_device
from aspire_tpu_torch.models.bert import BertConfig
from aspire_tpu_torch.models.encoders import ConSentEncoder
from aspire_tpu_torch.ops.distances import l2max_dist
from aspire_tpu_torch.text.fast import FastWordPiece
from aspire_tpu_torch.text.tokenize import prepare_abstracts

EX_ABSTRACTS = [
    {"TITLE": "Multi-Vector Models with Textual Guidance for Fine-Grained "
              "Scientific Document Similarity",
     "ABSTRACT": ["We present a new scientific document similarity model "
                  "based on matching fine-grained aspects.",
                  "Our model is trained using co-citation contexts as "
                  "textual supervision.",
                  "Matching is computed over contextual sentence embeddings."]},
    {"TITLE": "CSFCube: A Test Collection of Computer Science Papers",
     "ABSTRACT": ["We introduce a test collection for faceted query by "
                  "example retrieval.",
                  "Queries specify the facet of similarity to retrieve by.",
                  "We analyze a range of models on this task."]},
]


def parse_args(description: str, argv=None):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--weights-dir", help="local HF checkpoint directory")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def random_bert(module: torch.nn.Module, seed: int = 0) -> None:
    """Fill a BertModel's parameters from a seeded torch.Generator on the
    CPU (the same numbers on any device): N(0, 0.02), LayerNorms 1 and 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "LayerNorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


def example_tokenizer() -> FastWordPiece:
    """A WordPiece vocab of the example's words, as ex_consent.py builds
    it."""
    words = sorted({w.lower().strip(".,")
                    for ex in EX_ABSTRACTS
                    for s in [ex["TITLE"]] + ex["ABSTRACT"] for w in s.split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    return FastWordPiece(os.path.join(d, "vocab.txt"))


def load_bert(weights_dir, device):
    """(BertConfig, BertModel state_dict or None for random weights,
    tokenizer, the checkpoint's own tensors or None)."""
    if weights_dir:
        from aspire_tpu_torch.models.convert import load_hf_dir
        ckpt = load_hf_dir(weights_dir, device)
        return ckpt.config, ckpt.bert_state_dict(), ckpt.tokenizer, ckpt.hf_state_dict
    print("no --weights-dir: using a random tiny encoder (demo only)")
    return BertConfig.tiny(vocab_size=30522), None, example_tokenizer(), None


def encode_examples(args):
    """The ConSent encoder's (CLS reps, sentence reps, FeatureBatch) of
    EX_ABSTRACTS."""
    dev = require_device(args.device)
    cfg, bert_sd, tokenizer, _ = load_bert(args.weights_dir, dev)
    encoder = ConSentEncoder(cfg, max_sents=10, device=dev).eval()
    if bert_sd is None:
        random_bert(encoder.bert)
    else:
        encoder.bert.load_state_dict(bert_sd)
    fb = prepare_abstracts(EX_ABSTRACTS, tokenizer, max_sents=10)
    with torch.no_grad():
        cls, sents = encoder(torch.from_numpy(fb.token_ids).to(dev).long(),
                             torch.from_numpy(fb.attn_mask).to(dev),
                             torch.from_numpy(fb.sent_ids).to(dev).long())
    return cls, sents, fb


def query_and_cand(sents, fb):
    lens = torch.from_numpy(fb.abs_lens).to(sents.device)
    return (MultiVec(embed=sents[:1], lens=lens[:1]),
            MultiVec(embed=sents[1:], lens=lens[1:]))


def main(argv=None):
    args = parse_args(__doc__.split("\n")[0], argv)
    cls, sents, fb = encode_examples(args)
    print("doc CLS reps:", tuple(cls.shape), " sentence reps:", tuple(sents.shape))
    q, c = query_and_cand(sents, fb)
    with torch.no_grad():
        sims, pair_sims = l2max_dist(q, c, return_pair_sims=True)
    print("tsAspire similarity:", float(sims[0]))
    ql, cl = int(fb.abs_lens[0]), int(fb.abs_lens[1])
    best = np.unravel_index(pair_sims[0, :ql, :cl].cpu().numpy().argmax(), (ql, cl))
    print(f"best-matching sentence pair: query sent {best[0]} <-> cand sent {best[1]}")


if __name__ == "__main__":
    main()
