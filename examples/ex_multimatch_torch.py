"""Example: otAspire multi-match scoring with the Sinkhorn transport plan, on
the PyTorch/CUDA port (aspire_tpu_torch).

The port's twin of ex_multimatch.py: encode two abstracts, solve
entropy-regularized OT between their sentence sets (on the GPU the Sinkhorn
kernel runs the annealing loop), and print the transport plan (which
sentence pairs carry similarity mass), the same lines as ex_multimatch.py.

    python examples/ex_multimatch_torch.py [--weights-dir DIR] [--device cpu]
"""
import numpy as np
import torch

from aspire_tpu_torch.ops.distances import wasserstein_dist
from ex_consent_torch import encode_examples, parse_args, query_and_cand


def main(argv=None):
    args = parse_args(__doc__.split("\n")[0], argv)
    _, sents, fb = encode_examples(args)
    q, c = query_and_cand(sents, fb)
    with torch.no_grad():
        sims, (a, b, pair_sims, plan, masked) = wasserstein_dist(
            q, c, temp=5000.0, return_pair_sims=True)
    ql, cl = int(fb.abs_lens[0]), int(fb.abs_lens[1])
    print("otAspire similarity:", float(sims[0]))
    print("transport plan (query sents x cand sents):")
    print(np.round(plan[0, :ql, :cl].cpu().numpy(), 4))


if __name__ == "__main__":
    main()
