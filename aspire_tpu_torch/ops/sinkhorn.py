"""Log-domain epsilon-scaled Sinkhorn solver, geomloss-compatible.

Counterpart of aspire_tpu/ops/sinkhorn.py in plain PyTorch: the differentiable
solver that training and strict-parity scoring use.  The serving path runs the
same schedule inside one CUDA kernel (ops/sinkhorn_kernel.py).

  * ground cost  C(x, y) = |x - y|_2          (geomloss "p=1")
  * eps schedule: diameter -> blur, geometric with ratio `scaling`, with the
    first value repeated (geomloss epsilon_schedule semantics) and a final
    entry pinned at `blur`.
  * symmetric Jacobi updates with 0.5-averaging per iteration,
  * log-weights floored at -1e5 for zero-mass atoms (geomloss log_weights),
  * final "extrapolation" half-step at eps=blur which is the only step
    gradients flow through (geomloss detaches the loop; it runs under
    ``torch.no_grad()`` here),
  * balanced (reach=None) and unbalanced (reach=rho) damping.
"""
from __future__ import annotations

import math

import torch

from .cdist import pairwise_l2

_LOG_WEIGHT_FLOOR = -100000.0
_BIG = 3.0e38


def log_weights(a: torch.Tensor) -> torch.Tensor:
    """log(a) with zero/negative mass floored at -1e5 (geomloss log_weights).

    The inner clamp is a *normal* f32 so that log never sees 0 and no -inf
    leaks into gradients.
    """
    floor = torch.full_like(a, _LOG_WEIGHT_FLOOR)
    return torch.where(a > 0, torch.log(torch.clamp_min(a, 1e-30)), floor)


def max_diameter(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar diameter of the joint point cloud: |max - min|_2 over coords.

    Matches geomloss max_diameter: computed over ALL points of both clouds
    flattened across the batch (including zero pads -- the reference feeds
    padded reps straight into geomloss, so pads legitimately widen the box).
    """
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    yf = y.reshape(-1, d)
    mins = torch.minimum(xf.min(dim=0).values, yf.min(dim=0).values)
    maxs = torch.maximum(xf.max(dim=0).values, yf.max(dim=0).values)
    return torch.linalg.vector_norm(maxs - mins)


def grouped_max_diameter(x: torch.Tensor, y: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """`max_diameter` of each of `groups` equal contiguous slices of the batch,
    repeated for the slice's elements: f32[bsz].  What a loop of `groups`
    separate calls with diameter='global' would anneal from, in one call."""
    bsz, d = x.shape[0], x.shape[-1]
    if groups < 1 or bsz % groups:
        raise ValueError(f"batch {bsz} does not split into {groups} groups")
    xf = x.reshape(groups, -1, d)
    yf = y.reshape(groups, -1, d)
    mins = torch.minimum(xf.min(dim=1).values, yf.min(dim=1).values)
    maxs = torch.maximum(xf.max(dim=1).values, yf.max(dim=1).values)
    diam = torch.linalg.vector_norm(maxs - mins, dim=-1)
    return diam.repeat_interleave(bsz // groups)


def _box(x: torch.Tensor, w: torch.Tensor | None):
    if w is None:
        return x.min(dim=1).values, x.max(dim=1).values
    m = (w > 0)[:, :, None]
    lo = torch.where(m, x, torch.full_like(x, _BIG)).min(dim=1).values
    hi = torch.where(m, x, torch.full_like(x, -_BIG)).max(dim=1).values
    return lo, hi


def pairwise_diameter(x: torch.Tensor, y: torch.Tensor,
                      x_weights: torch.Tensor | None = None,
                      y_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-batch-element diameter f32[bsz]: each pair gets its own box.

    This is what geomloss sees when the reference scores pairs ONE AT A TIME
    (evaluate.py:35-82 feeds 1x1 pairs).  When weights are given (zero mass =
    pad), zero-weight rows are excluded from the box.  Each element must keep
    >= 1 real row per side."""
    mins_x, maxs_x = _box(x, x_weights)
    mins_y, maxs_y = _box(y, y_weights)
    mins = torch.minimum(mins_x, mins_y)
    maxs = torch.maximum(maxs_x, maxs_y)
    return torch.linalg.vector_norm(maxs - mins, dim=-1)


def _schedule_len(diameter: torch.Tensor, blur: float,
                  scaling: float) -> torch.Tensor:
    """Number of annealing-loop iterations = len(geomloss eps_list).

    eps_list = [d] + [d * s^k for k in 0..K-1] + [blur] with
    K = ceil(log(blur/d) / log(s)), so len = K + 2.  For d < blur K = 0.
    """
    ratio = torch.log(blur / torch.clamp_min(diameter, 1e-30)) / math.log(scaling)
    k = torch.ceil(torch.clamp_min(ratio, 0.0)).to(torch.int32)
    return k + 2


def _eps_at(i: int, diameter: torch.Tensor, blur: float, scaling: float,
            n_iters: torch.Tensor) -> torch.Tensor:
    """eps_list[i]: [d, d, d*s, d*s^2, ..., blur].

    The LAST schedule entry is pinned at blur; earlier entries are NOT
    floored there, so a degenerate cloud with d < blur runs geomloss's
    [d, blur] schedule.  The 1e-12 floor only guards eps=0 division for
    coincident clouds."""
    k = float(max(i - 1, 0))
    d = torch.clamp_min(diameter, 1e-12)
    anneal = d * torch.pow(torch.tensor(scaling, dtype=torch.float32,
                                        device=d.device), k)
    return torch.where(i >= n_iters - 1, torch.full_like(d, blur), anneal)


def resolve_diameter(x, y, a, b, diameter: str, diameter_value) -> torch.Tensor:
    """Per-pair annealing-start diameter f32[bsz] for either mode."""
    bsz = a.shape[0]
    if diameter_value is not None:
        diam = torch.as_tensor(diameter_value, dtype=torch.float32,
                               device=a.device)
    elif diameter == "pair":
        diam = pairwise_diameter(x, y, a, b)
    elif diameter == "global":
        diam = max_diameter(x, y)
    else:
        raise ValueError(f"diameter must be 'global' or 'pair', got {diameter!r}")
    return diam.detach().float().broadcast_to((bsz,))


def _softmin(eps, cost_, h):
    # eps: [bsz]; cost_: [bsz, n, m]; h: [bsz, m] -> [bsz, n]
    return -eps[:, None] * torch.logsumexp(
        h[:, None, :] - cost_ / eps[:, None, None], dim=2)


def sinkhorn_potentials(
    a: torch.Tensor,
    x: torch.Tensor,
    b: torch.Tensor,
    y: torch.Tensor,
    blur: float = 0.05,
    scaling: float = 0.9,
    reach: float | None = None,
    max_iters: int = 128,
    cost: torch.Tensor | None = None,
    use_cost: bool = False,
    diameter: str = "global",
    diameter_value: torch.Tensor | None = None,
):
    """Solve regularized OT between weighted point clouds; return potentials.

    a: [bsz, n] source weights (may contain zeros for pads)
    x: [bsz, n, d] source points
    b: [bsz, m] target weights
    y: [bsz, m, d] target points
    cost: optional precomputed f32[bsz, n, m] ground cost (pass use_cost=True);
        otherwise the L2 ("p=1") cost is computed from x, y.
    diameter: 'global' anneals from the whole-batch diameter, 'pair' anneals
        each batch element from its own.
    diameter_value: optional precomputed annealing-start diameter (scalar or
        f32[bsz]), overriding the local computation.

    Returns (f, g): potentials f32[bsz, n], f32[bsz, m] such that the balanced
    OT cost is sum(a * f + b * g) -- geomloss's potentials=True output for
    debias=False.  The loop reads its trip count on the host (one sync); the
    serving path avoids that by running the CUDA kernel instead.
    """
    if not 0.0 < scaling < 1.0:
        raise ValueError(f"scaling must be in (0, 1), got {scaling}")
    a = a.float()
    b = b.float()
    c_xy = cost.float() if use_cost else pairwise_l2(x, y)
    c_yx = c_xy.transpose(1, 2)
    bsz = a.shape[0]
    diam = resolve_diameter(x, y, a, b, diameter, diameter_value)
    n_iters = _schedule_len(diam, blur, scaling)
    log_a = log_weights(a)
    log_b = log_weights(b)

    def damping(eps):
        if reach is None:
            return 1.0
        return 1.0 / (1.0 + eps[:, None] / float(reach))

    # --- Annealing loop: constant w.r.t. gradients (geomloss detaches it). ---
    with torch.no_grad():
        c_xy_ng, c_yx_ng = c_xy.detach(), c_yx.detach()
        la, lb = log_a.detach(), log_b.detach()
        eps0 = _eps_at(0, diam, blur, scaling, n_iters)
        f = damping(eps0) * _softmin(eps0, c_xy_ng, lb)
        g = damping(eps0) * _softmin(eps0, c_yx_ng, la)
        n_cap = min(int(n_iters.max()), max_iters)
        for i in range(n_cap):
            eps = _eps_at(i, diam, blur, scaling, n_iters)
            ft = damping(eps) * _softmin(eps, c_xy_ng, lb + g / eps[:, None])
            gt = damping(eps) * _softmin(eps, c_yx_ng, la + f / eps[:, None])
            live = (i < n_iters)[:, None]
            f = torch.where(live, 0.5 * (f + ft), f)
            g = torch.where(live, 0.5 * (g + gt), g)

    # --- Final extrapolation at eps = blur: the differentiable step. ---
    eps_b = torch.full((bsz,), blur, dtype=torch.float32, device=a.device)
    damp = damping(eps_b)
    f_out = damp * _softmin(eps_b, c_xy, log_b + g / blur)
    g_out = damp * _softmin(eps_b, c_yx, log_a + f / blur)
    return f_out, g_out


def sinkhorn_cost(a, f, b, g, blur: float = 0.05,
                  reach: float | None = None) -> torch.Tensor:
    """OT cost from potentials: geomloss sinkhorn_cost with debias=False.

    Balanced: <a, f> + <b, g>.  Unbalanced: the KL-relaxed dual value with the
    (rho + eps/2) weighting geomloss applies.
    """
    if reach is None:
        return torch.sum(a * f, dim=-1) + torch.sum(b * g, dim=-1)
    rho = float(reach)
    w = rho + blur / 2.0
    fa = w * (1.0 - torch.exp(-f / rho))
    gb = w * (1.0 - torch.exp(-g / rho))
    return torch.sum(a * fa, dim=-1) + torch.sum(b * gb, dim=-1)
