from .bert import BertConfig, BertModel, BertPooler
from .encoders import (ConSentEncoder, ConSentSpanEncoder, BiEncoder,
                       sentence_pool, span_pool)
