"""Plain BERT forward in float32 (TF32 off), from the weight table's slices,
with the two heads the configurations use: sentence mean-pooling
(AspireConSent) and the softmax mix of the layers' CLS vectors (SPECTER-CoCite
bi-encoder).  Follows BERT's published equations (post-LayerNorm, erf GELU,
an additive -1e9 key mask); imports nothing of the program.

`lower=True` is the control: the forward computed in float8 e4m3 (a
per-tensor scale, amax / 448) where the configuration states bfloat16, the
step a faster encoder would be tempted to take.  It rounds at the points
where a bf16 encoder rounds: the three embeddings, every LayerNorm's output,
every product's operands and output, the attention probabilities and the
FFN's activation; sums, softmax and LayerNorm statistics stay float32."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _round(x: torch.Tensor, lower: bool) -> torch.Tensor:
    return fp8(x) if lower else x


def _mm(a: torch.Tensor, b: torch.Tensor, lower: bool) -> torch.Tensor:
    return _round(torch.matmul(_round(a, lower), _round(b, lower)), lower)


def _linear(x, w, b, lower):
    return _round(_mm(x, w.t(), lower) + b, lower)


def _ln(x, w, b, eps, lower):
    return _round(F.layer_norm(x, (x.shape[-1],), w, b, eps), lower)


def hidden_states(w: dict, cfg: dict, token_ids, attn_mask, lower=False) -> list:
    """f32 [b, t, h] after the embeddings and after each layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["layer_norm_eps"]
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = h // nh
    b, t = token_ids.shape
    ids = token_ids.long()
    x = (_round(w["emb.word"][ids], lower) + _round(w["emb.pos"][:t], lower)[None]
         + _round(w["emb.type"][0], lower)[None, None])
    x = _ln(x, w["emb.ln.w"], w["emb.ln.b"], eps, lower)
    bias = torch.where(attn_mask > 0, 0.0, -1e9).float()[:, None, None, :]
    out = [x]
    for i in range(cfg["num_hidden_layers"]):
        p = f"l{i}."
        heads = [_linear(x, w[p + n + ".w"], w[p + n + ".b"], lower)
                 .view(b, t, nh, hd).transpose(1, 2) for n in ("q", "k", "v")]
        q, k, v = heads
        # q and k are rounded; their product is kept in f32, as attention kernels keep it
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        ctx = _mm(torch.softmax(scores, dim=-1), v, lower)   # rounds the probabilities
        ctx = ctx.transpose(1, 2).reshape(b, t, h)
        a = _linear(ctx, w[p + "ao.w"], w[p + "ao.b"], lower)
        x = _ln(x + a, w[p + "ln1.w"], w[p + "ln1.b"], eps, lower)
        inter = _round(F.gelu(_mm(x, w[p + "i.w"].t(), lower) + w[p + "i.b"]), lower)
        o = _linear(inter, w[p + "o.w"], w[p + "o.b"], lower)
        x = _ln(x + o, w[p + "ln2.w"], w[p + "ln2.b"], eps, lower)
        out.append(x)
    return out


def sentence_reps(w, cfg, token_ids, attn_mask, sent_ids, max_sents: int,
                  lower=False) -> torch.Tensor:
    """AspireConSent: the mean of each sentence's final token vectors,
    f32 [b, max_sents, h] (zeros where a sentence has no tokens)."""
    last = hidden_states(w, cfg, token_ids, attn_mask, lower)[-1]
    b, t, h = last.shape
    sid = sent_ids.long()
    keep = (sid >= 0) & (sid < max_sents)
    slot = torch.where(keep, sid, torch.full_like(sid, max_sents))
    sums = torch.zeros((b, max_sents + 1, h), dtype=torch.float32,
                       device=last.device)
    sums.scatter_add_(1, slot[:, :, None].expand(b, t, h), last)
    counts = torch.zeros((b, max_sents + 1), dtype=torch.float32,
                         device=last.device)
    counts.scatter_add_(1, slot, keep.float())
    return (sums / counts.clamp_min(1.0)[:, :, None])[:, :max_sents]


def mixed_cls(w, cfg, token_ids, attn_mask, lower=False) -> torch.Tensor:
    """SPECTER-CoCite bi-encoder: the layers' CLS vectors mixed by the
    softmax of the learned layer weights, f32 [b, h]."""
    states = hidden_states(w, cfg, token_ids, attn_mask, lower)
    mix = torch.softmax(w["mix"], dim=0)
    return sum(m * s[:, 0, :] for m, s in zip(mix, states))
