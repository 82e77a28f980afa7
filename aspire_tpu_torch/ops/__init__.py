from .cdist import pairwise_l2
from .sinkhorn import sinkhorn_potentials, sinkhorn_cost, log_weights
from .sinkhorn_kernel import sinkhorn_potentials_kernel
from .attention_kernel import fused_attention
from .ffn_kernel import fused_ffn
from .distances import (
    l2max_dist,
    l2topk_dist,
    l2sup_dist,
    l2sup_weighted_dist,
    attention_dist,
    wasserstein_dist,
    jointsm_dist,
    get_dist_function,
)
