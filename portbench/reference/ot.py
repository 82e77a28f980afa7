"""Plain optimal-transport scores (otAspire), by geomloss's log-domain
epsilon-scaling Sinkhorn, in float64 by default.  Imports nothing of the
program.

Semantics (the reference's AllPairMaskedWasserstein at test time):
  * ground cost C = |x - y|_2 between padded sentence sets; the similarity
    matrix -C is masked with -1e9 outside the real (query, candidate) block;
  * marginals: softmax over each sentence's best similarity / temp;
  * the schedule: diameter d, then d s^k down to blur, a final step at blur,
    `len = ceil(log(blur / d) / log(s)) + 2` rounds (capped at max_iters),
    symmetric updates averaged by halves, log-weights floored at -1e5;
  * the diameter: of the box spanning every point of a query's whole pool,
    padding included (`groups`: consecutive pairs sharing a query), or of
    each pair's own atoms with mass (`groups=None`);
  * the score: sum of plan x masked similarity, the plan from the potentials
    after the final step.

`dtype=torch.bfloat16` is the control: the whole solve in bfloat16, the
step below the float32 that the configuration states."""
from __future__ import annotations

import math

import torch

PAD_NEG = -1e9
LOG_FLOOR = -1e5


def _cost(x, y):
    xx = (x * x).sum(-1)[:, :, None]
    yy = (y * y).sum(-1)[:, None, :]
    return (xx + yy - 2.0 * torch.matmul(x, y.transpose(1, 2))).clamp_min(0).sqrt()


def _box_norm(lo, hi):
    return torch.linalg.vector_norm((hi - lo).double(), dim=-1)


def diameters(x, y, a, b, groups: int | None):
    """f64 [P] annealing diameters (see the module's docstring)."""
    if groups is not None:
        p = x.shape[0]
        xs = x.reshape(groups, -1, x.shape[-1])
        ys = y.reshape(groups, -1, y.shape[-1])
        lo = torch.minimum(xs.amin(1), ys.amin(1))
        hi = torch.maximum(xs.amax(1), ys.amax(1))
        return _box_norm(lo, hi).repeat_interleave(p // groups)
    big = torch.finfo(x.dtype).max
    am, bm = (a > 0)[:, :, None], (b > 0)[:, :, None]
    lo = torch.minimum(torch.where(am, x, big).amin(1), torch.where(bm, y, big).amin(1))
    hi = torch.maximum(torch.where(am, x, -big).amax(1),
                       torch.where(bm, y, -big).amax(1))
    return _box_norm(lo, hi)


def scores(q, q_lens, c, c_lens, temp: float, blur: float = 0.05,
           scaling: float = 0.9, max_iters: int = 128, groups: int | None = None,
           dtype=torch.float64) -> torch.Tensor:
    """OT similarity of each pair: q [P, n, d], c [P, m, d] zero-padded past
    q_lens, c_lens -> f64 [P]."""
    x, y = q.to(dtype), c.to(dtype)
    n, m = x.shape[1], y.shape[1]
    qm = (torch.arange(n, device=x.device)[None, :] < q_lens[:, None]).to(dtype)
    cm = (torch.arange(m, device=x.device)[None, :] < c_lens[:, None]).to(dtype)
    mask = qm[:, :, None] * cm[:, None, :]
    cost = _cost(x, y)
    neg = -cost + (1.0 - mask) * PAD_NEG
    a = torch.softmax(neg.amax(2) / temp, dim=1)
    b = torch.softmax(neg.amax(1) / temp, dim=1)
    diam = diameters(x, y, a, b, groups)
    la = torch.where(a > 0, torch.log(a.clamp_min(1e-30)), torch.full_like(a, LOG_FLOOR))
    lb = torch.where(b > 0, torch.log(b.clamp_min(1e-30)), torch.full_like(b, LOG_FLOOR))
    ratio = torch.log(blur / diam.clamp_min(1e-30)) / math.log(scaling)
    n_iters = torch.ceil(ratio.clamp_min(0.0)) + 2
    d = diam.clamp_min(1e-12)
    cost_t = cost.transpose(1, 2)

    def eps_at(i: int):
        e = d * scaling ** max(i - 1, 0)
        return torch.where(i >= n_iters - 1, torch.full_like(e, blur), e).to(dtype)

    def softmin(eps, c_, h):
        return -eps[:, None] * torch.logsumexp(h[:, None, :] - c_ / eps[:, None, None], dim=2)

    e0 = eps_at(0)
    f, g = softmin(e0, cost, lb), softmin(e0, cost_t, la)
    for i in range(min(int(n_iters.max()), max_iters)):
        e = eps_at(i)
        ft = softmin(e, cost, lb + g / e[:, None])
        gt = softmin(e, cost_t, la + f / e[:, None])
        live = (i < n_iters)[:, None]
        f, g = torch.where(live, 0.5 * (f + ft), f), torch.where(live, 0.5 * (g + gt), g)
    eb = torch.full_like(e0, blur)
    f_out = softmin(eb, cost, lb + g / blur)
    g_out = softmin(eb, cost_t, la + f / blur)
    masked = neg * mask
    plan = torch.exp(((f_out[:, :, None] + g_out[:, None, :]) * mask + masked) / blur)
    plan = plan * (a[:, :, None] * b[:, None, :])
    return (plan * masked).sum(dim=(1, 2)).double()
