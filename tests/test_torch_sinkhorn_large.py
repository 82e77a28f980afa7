"""Sinkhorn pairs past one block's shared memory, the large-pair kernel's
range (`sinkhorn_route(n, m) == "large"`: 240 x 240 and up, a side past 1,024
atoms).  On CPU tensors the wrapper runs `sinkhorn_solve_plain`; here it is
held against the JAX package's solvers at 240 x 240, 24 x 1,100 and 300 x 256,
in both modes: after the final step against the Pallas kernel in interpret
mode (`sinkhorn_potentials_pallas`, which takes any n x m), and the loop's own
potentials with the final step taken in PyTorch (`loop="kernel"`, the
training route) against the XLA solver.  Then the port's `ot_rerank` against
the JAX one (solver "pallas", its serving default) on a full-text query and
candidates of up to 300 sentences.

Tolerances: KTOL of test_torch_sinkhorn.py (1e-3: the kernel form multiplies
by 1/eps and builds eps from exp(k log s) where the solvers divide and use
pow, over about 85 rounds), on the atoms with mass.  The rerank's scores:
the JAX package's own limit between its two solvers (2e-3 relative and
absolute, tests/test_pallas.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.types import MultiVec as JMV
from aspire_tpu.index import serve as jserve
from aspire_tpu.ops import sinkhorn as js
from aspire_tpu.ops.pallas_sinkhorn import sinkhorn_potentials_pallas
from aspire_tpu_torch.core.types import MultiVec as TMV
from aspire_tpu_torch.index import serve as tserve
from aspire_tpu_torch.ops import sinkhorn as ts
from aspire_tpu_torch.ops.sinkhorn_kernel import (sinkhorn_potentials_kernel,
                                                  sinkhorn_route, sinkhorn_solve)

from test_torch_sinkhorn import KTOL, _check_mass, _clouds, _j, _t

SHAPES = [(240, 240), (24, 1100), (300, 256)]


@pytest.mark.parametrize("n,m", SHAPES, ids=[f"{n}x{m}" for n, m in SHAPES])
@pytest.mark.parametrize("diameter", ["global", "pair"])
def test_large_pairs_after_the_final_step_match_pallas(rng, n, m, diameter):
    assert sinkhorn_route(n, m) == "large"
    a, x, b, y = _clouds(rng, bsz=2, n=n, m=m, d=16)
    f, g = sinkhorn_potentials_kernel(*_t(a, x, b, y), diameter=diameter)
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), diameter=diameter,
                                        interpret=True)
    assert f.shape == (2, n) and g.shape == (2, m)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)


@pytest.mark.parametrize("n,m", SHAPES, ids=[f"{n}x{m}" for n, m in SHAPES])
def test_large_pairs_loop_only_then_torch_step_match_xla(rng, n, m):
    """The training route: the loop's own potentials from the wrapper
    (extrapolate=False; no launch on the CPU), the final step in PyTorch."""
    a, x, b, y = _clouds(rng, bsz=2, n=n, m=m, d=16)
    before = (sinkhorn_solve.launches, sinkhorn_solve.large_launches)
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y), loop="kernel", diameter="pair")
    assert (sinkhorn_solve.launches, sinkhorn_solve.large_launches) == before
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y), diameter="pair")
    _check_mass(f.detach(), fj, a, KTOL)
    _check_mass(g.detach(), gj, b, KTOL)


def _docs(rng, k, smax, d=32, lo=None):
    lens = rng.integers(lo or smax // 2, smax + 1, k)
    emb = (rng.standard_normal((k, smax, d)) * 0.5).astype(np.float32)
    emb *= (np.arange(smax)[None, :] < lens[:, None])[:, :, None]
    return emb, lens.astype(np.int32)


def test_ot_rerank_of_300_sentence_candidates_matches_jax(rng):
    """A full-text query (up to 300 sentences) against candidates of up to
    300: the pairs run padded to 300 x 300, the large kernel's range."""
    q_emb, q_lens = _docs(rng, 1, 300, lo=240)
    c_emb, c_lens = _docs(rng, 6, 300, lo=240)
    assert sinkhorn_route(300, 300) == "large"
    got = tserve.ot_rerank(TMV(*_t(q_emb, q_lens.astype(np.int64))),
                           TMV(*_t(c_emb, c_lens.astype(np.int64))), temp=5000.0)
    want = jserve.ot_rerank(JMV(*_j(q_emb, q_lens)), JMV(*_j(c_emb, c_lens)),
                            temp=5000.0)
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
    assert np.array_equal(np.argsort(-got.numpy()), np.argsort(-np.asarray(want)))
