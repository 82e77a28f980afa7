"""Sentence-alignment encoders for tsAspire supervision mining (the port's
copy of aspire_tpu/data/align.py).

The reference computes `cc_align`/`abs_align` with a SentenceTransformer
(`encode_multi_process` over contexts + abstract sentences, then argmax
dot-sims -- pre_proc_cocits.py:447-455).  This framework's analogue plugs
its OWN trained sentence encoder (cosentbert / ictsentbert, the models the
reference also trains for exactly this purpose) into
`preprocess.generate_examples_cocitabs(aligner=...)`:

  mine co-citations -> train cosentbert on the sentence pairs
  -> align co-cited abstracts with it -> train tsAspire on the alignments

so the full two-model supervision pipeline is self-contained.  The encoder
runs in f32 on `device`: on a CUDA device each encode goes through the f32
attention and FFN kernels (K2 f32, K3 f32) once a layer.
"""
from __future__ import annotations

import numpy as np


def trained_sent_aligner(run_dir: str, tokenizer, model_name: str = "cosentbert",
                         batch_size: int = 64, device="cuda"):
    """callable(list[str]) -> np.ndarray [n, d] from a trained sentence-
    encoder run (the port's run_info.json + model_cur_best.pt contract).

    The returned reps are L2-NORMALIZED so the argmax of the dot-product
    matrix in generate_examples_cocitabs picks the most-similar pair by
    cosine, matching the reference's normalized SentenceTransformer usage.
    tokenizer: a tokenizer instance or a local tokenizer dir path (vocab.txt,
    read by the port's FastWordPiece).  The callable's `model` attribute is
    the evaluation model that encodes.
    """
    if isinstance(tokenizer, str):
        from ..text.fast import FastWordPiece
        tokenizer = FastWordPiece.from_dir(tokenizer)
    from ..evaluation.models import get_model
    model = get_model(model_name, trained_model_path=run_dir,
                      tokenizer=tokenizer, batch_size=batch_size, device=device)

    def embed(sents: list[str]) -> np.ndarray:
        # TrainedSentSimilarityModel encodes one "paper" as a per-sentence
        # CLS matrix; a synthetic single paper holding the sentence list is
        # exactly the flat batch we need
        reps = model.encode([{"TITLE": "", "ABSTRACT": list(sents)}])[0]
        reps = np.asarray(reps, np.float32)
        return reps / np.clip(np.linalg.norm(reps, axis=1, keepdims=True),
                              1e-9, None)

    embed.model = model
    return embed
