from .serve import ot_rerank, l2max_rerank
