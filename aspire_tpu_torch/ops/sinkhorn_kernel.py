"""CUDA Sinkhorn solver: wrapper, launch count and plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_sinkhorn.py:_sinkhorn_kernel``
(entry point ``sinkhorn_potentials_pallas``): forward-only batched balanced
log-domain Sinkhorn with a per-pair eps schedule.  The CUDA source is
``csrc/sinkhorn.cu``; the whole annealing loop runs on chip -- one read of the
cost, one write of the potentials -- and each pair stops after its own
schedule length, which also removes the host-side read of the batch maximum
that the TPU version needs.  The loop is a chain of about 85 dependent rounds,
so at small batches its latency bounds it, not the card's rate.  Three
kernels share the schedule, chosen by shape alone (`sinkhorn_route`): pairs
of up to 32 x 32 run one block a pair with four threads a softmin, the cost in
registers and base-2 exponentials ("small"); wider pairs up to 1024 atoms a
side whose pair fits one block's shared memory (239 x 239 does, 240 x 240
does not) run one warp a pair with the cost in shared memory ("wide"); every
other pair, while f, g and h of both sides fit a block's shared memory
(n + m <= 29,056), runs one block a pair with the cost and its transpose read
from global memory each half-round, one warp a softmin ("large", launches
counted apart).

``extrapolate=False`` returns the loop's own potentials, before the final
step at eps = blur: the training loss takes that step in PyTorch, where
gradients flow (`ops.sinkhorn.sinkhorn_potentials(loop="kernel")`).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .cdist import pairwise_l2
from .sinkhorn import log_weights, resolve_diameter

MAX_SMEM = 232_448   # shared memory of one block on the H100, bytes
MAX_SIDE = 1024      # the wide kernel's atoms a side: 32 lanes x at most 32
SMALL_SIDE = 32      # pairs up to 32 x 32 keep the cost in registers
TABLE = 128          # rounds whose eps the small-pair kernel tabulates


def pair_bytes(n: int, m: int) -> int:
    """Shared memory the kernel keeps for one n x m pair: up to 32 atoms a
    side two buffers of h (32 floats a side each) and log2(e) / eps of 128
    rounds with its reciprocal; above, the cost with an odd row pitch (m | 1)
    and one float an atom of either side."""
    if max(n, m) <= SMALL_SIDE:
        return 4 * (2 * 2 * SMALL_SIDE + 2 * TABLE)
    return 4 * (n * (m | 1) + n + m)


def large_bytes(n: int, m: int) -> int:
    """Shared memory of the large-pair kernel: f, g and h of both sides."""
    return 8 * (n + m)


def sinkhorn_route(n: int, m: int) -> str:
    """'small', 'wide' or 'large': which kernel takes an n x m pair (the first
    two on today's conditions); raises past the large kernel's shared memory."""
    if max(n, m) <= SMALL_SIDE:
        return "small"
    if max(n, m) <= MAX_SIDE and pair_bytes(n, m) <= MAX_SMEM:
        return "wide"
    if large_bytes(n, m) <= MAX_SMEM:
        return "large"
    raise ValueError(f"the Sinkhorn kernels take pairs whose potentials fit one "
                     f"block's shared memory ({MAX_SMEM} bytes); {n} x {m} "
                     f"needs {large_bytes(n, m)}")


def sinkhorn_solve_plain(cost, log_a, log_b, diam, blur: float = 0.05,
                         scaling: float = 0.9, max_iters: int = 128,
                         extrapolate: bool = True):
    """Plain PyTorch version of the kernels, same arithmetic order (it
    multiplies by 1 / eps and takes eps from exp(k log s)), but for one step:
    the kernels divide each softmin's log-sum by the factor that scaled its
    terms, where this multiplies it by eps.

    cost f32[B, n, m], log_a f32[B, n], log_b f32[B, m], diam f32[B]
    -> (f [B, n], g [B, m]): after the final step at eps = blur, or with
    extrapolate=False the annealing loop's own potentials.
    """
    log_s = math.log(scaling)
    ratio = torch.log(blur / torch.clamp_min(diam, 1e-30)) / log_s
    lane_iters = torch.ceil(torch.clamp_min(ratio, 0.0)) + 2.0    # [B]
    d = torch.clamp_min(diam, 1e-12)

    def eps_at(i):
        k = float(max(i - 1, 0))
        return torch.where(i >= lane_iters - 1.0, torch.full_like(d, blur),
                           d * math.exp(k * log_s))[:, None]

    def softmin_m(eps, ce, h):      # over the m axis -> [B, n]
        return -eps * torch.logsumexp(h[:, None, :] - ce, dim=2)

    def softmin_n(eps, ce, h):      # over the n axis -> [B, m]
        return -eps * torch.logsumexp(h[:, :, None] - ce, dim=1)

    eps = eps_at(0)
    ce = cost * (1.0 / eps)[:, :, None]
    f = softmin_m(eps, ce, log_b)
    g = softmin_n(eps, ce, log_a)
    n_cap = min(int(lane_iters.max()), max_iters)
    for i in range(n_cap):
        eps = eps_at(i)
        inv = 1.0 / eps
        ce = cost * inv[:, :, None]
        ft = softmin_m(eps, ce, log_b + g * inv)
        gt = softmin_n(eps, ce, log_a + f * inv)
        live = (i < lane_iters)[:, None]
        f, g = (torch.where(live, 0.5 * (f + ft), f),
                torch.where(live, 0.5 * (g + gt), g))
    if not extrapolate:
        return f, g
    ce = cost * (1.0 / blur)
    return (softmin_m(blur, ce, log_b + g / blur),
            softmin_n(blur, ce, log_a + f / blur))


def sinkhorn_solve(cost, log_a, log_b, diam, blur: float = 0.05,
                   scaling: float = 0.9, max_iters: int = 128,
                   extrapolate: bool = True):
    """The kernel's wrapper: CUDA tensors launch it, CPU tensors run the
    plain version.  Same arguments and results as `sinkhorn_solve_plain`."""
    bsz, n, m = cost.shape
    if log_a.shape != (bsz, n) or log_b.shape != (bsz, m) or diam.shape != (bsz,):
        raise ValueError("log_a, log_b, diam must be [B, n], [B, m], [B]")
    if not cost.is_cuda:
        return sinkhorn_solve_plain(cost, log_a, log_b, diam, blur, scaling,
                                    max_iters, extrapolate)
    large = sinkhorn_route(n, m) == "large"
    args = [t.detach().float().contiguous() for t in (cost, log_a, log_b, diam)]
    if any(t.device != cost.device for t in args):
        raise ValueError("all inputs must lie on the same device")
    f = torch.empty((bsz, n), dtype=torch.float32, device=cost.device)
    g = torch.empty((bsz, m), dtype=torch.float32, device=cost.device)
    if bsz == 0:
        return f, g
    if large:          # g's softmins read the rows of the transpose
        args.insert(1, args[0].transpose(1, 2).contiguous())
    name = "aspire_sinkhorn_large_f32" if large else "aspire_sinkhorn_f32"
    lib = _build.load()
    with torch.cuda.device(cost.device):
        err = getattr(lib, name)(
            *(t.data_ptr() for t in args), f.data_ptr(), g.data_ptr(),
            bsz, n, m, float(blur), math.log(scaling), int(max_iters),
            int(extrapolate), torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    if large:
        sinkhorn_solve.large_launches += 1
    else:
        sinkhorn_solve.launches += 1
    return f, g


# launches of the small- and wide-pair kernels, and of the large-pair one
sinkhorn_solve.launches = 0
sinkhorn_solve.large_launches = 0


def sinkhorn_potentials_kernel(
    a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
    blur: float = 0.05, scaling: float = 0.9, max_iters: int = 128,
    cost: torch.Tensor | None = None, use_cost: bool = False,
    diameter: str = "global", diameter_value: torch.Tensor | None = None,
):
    """Forward-only replacement for sinkhorn_potentials (balanced case).

    a: [bsz, n]; x: [bsz, n, d]; b: [bsz, m]; y: [bsz, m, d].
    cost: optional precomputed f32[bsz, n, m] ground cost (use_cost=True).
    diameter: 'global' or 'pair'; either way the kernel receives a per-pair
    diameter computed here in plain PyTorch.
    Returns (f [bsz, n], g [bsz, m]) float32, without gradients.
    """
    if not 0.0 < scaling < 1.0:
        raise ValueError(f"scaling must be in (0, 1), got {scaling}")
    with torch.no_grad():
        c = cost.float() if use_cost else pairwise_l2(x, y)
        diam = resolve_diameter(x, y, a, b, diameter, diameter_value)
        return sinkhorn_solve(c, log_weights(a.float()), log_weights(b.float()),
                              diam, blur, scaling, max_iters)
