"""Example: SPECTER-CoCite bi-encoder (CLS rep with softmax layer mix), on the
PyTorch/CUDA port (aspire_tpu_torch).

The port's twin of ex_bienc.py: encode abstracts to single CLS vectors via
the scalar mix over all hidden-state layers and compare with -L2 distance.
The mix weights come from the checkpoint (``bert_layer_weights``), zeros
when it has none.  It prints the same lines as ex_bienc.py.

    python examples/ex_bienc_torch.py [--weights-dir DIR] [--device cpu]
"""
import numpy as np
import torch

from aspire_tpu_torch.core.types import require_device
from aspire_tpu_torch.models.encoders import (BiEncoder,
                                              bienc_layer_weights_from_state_dict)
from ex_consent_torch import EX_ABSTRACTS, load_bert, parse_args, random_bert


def main(argv=None):
    args = parse_args(__doc__.split("\n")[0], argv)
    dev = require_device(args.device)
    cfg, bert_sd, tokenizer, hf_sd = load_bert(args.weights_dir, dev)
    enc = BiEncoder(cfg, device=dev).eval()
    if bert_sd is None:
        random_bert(enc.bert)
    else:
        enc.bert.load_state_dict(bert_sd)
        try:
            lw = bienc_layer_weights_from_state_dict(hf_sd)
        except KeyError:
            lw = torch.zeros(cfg.num_hidden_layers + 1)
        with torch.no_grad():
            enc.layer_weights.copy_(lw)
    texts = [ex["TITLE"] + " [SEP] " + " ".join(ex["ABSTRACT"]) for ex in EX_ABSTRACTS]
    rows = [tokenizer.build_inputs_with_special_tokens(
        tokenizer.convert_tokens_to_ids(tokenizer.tokenize(t)[:500])) for t in texts]
    t = max(len(r) for r in rows)
    token_ids = np.full((len(rows), t), tokenizer.pad_token_id, np.int64)
    attn = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        token_ids[i, :len(r)] = r
        attn[i, :len(r)] = 1
    with torch.no_grad():
        cls = enc(torch.from_numpy(token_ids).to(dev), torch.from_numpy(attn).to(dev))
    print("CLS reps:", tuple(cls.shape))
    sim = -float(torch.linalg.norm(cls[0] - cls[1]))
    print("bi-encoder similarity (-L2):", sim)


if __name__ == "__main__":
    main()
