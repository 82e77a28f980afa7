from .types import (MultiVec, PAD_NEG, SOFTMAX_NEG, masked_softmax,
                    masked_2d_softmax, require_device)
