"""Evaluation model zoo + plugin API (SimilarityModel): the port's own copy of
aspire_tpu/evaluation/models.py, itself a re-design of
src/evaluation/utils/models.py:23-768.

The public surface is the JAX package's -- `encode`, `get_similarity`, the
h5py encodings cache, `get_faceted_encoding`, the `get_model` factory -- and
`get_similarities` scores a query against a whole list of candidates in one
batched call: on a CUDA device a chunk of candidates is one launch of the
Sinkhorn kernel (K1) with `ot_solver="pallas"`, and the encode runs the
attention (K2), FFN (K3) and sentence-pool (K4) kernels.  Every module runs
in eval mode under `torch.no_grad()` on the device it was built for
(`device="cuda"` unless the caller asks for the CPU).

Weight sources, all local files:
  * HF checkpoint directories (config.json, pytorch_model.bin or
    model.safetensors, vocab.txt) through models/convert.load_hf_dir;
  * the port's own training runs: run_info.json + model_{version}.pt, as
    train/trainer.py writes them.  The JAX package's orbax trees cannot be
    read without JAX.
"""
from __future__ import annotations

import logging
import os
from abc import ABCMeta, abstractmethod

import numpy as np
import torch

from ..core.config import RunConfig
from ..core.types import MultiVec, require_device
from ..models.bert import BertConfig, BertModel, BertPooler
from ..models.encoders import BiEncoder, ConSentEncoder, ConSentSpanEncoder
from ..ops.cdist import require_fp32_matmul
from ..ops.distances import jointsm_dist, l2max_dist, wasserstein_dist
from ..text.tokenize import ner_token_spans, prepare_abstracts, spans_to_mask

log = logging.getLogger(__name__)

# the JAX package's OT solver names -> the port's (ops/distances.py)
OT_SOLVERS = {"xla": "torch", "pallas": "kernel"}
AGGS = ("ot", "l2max", "jointsm", "cosine_max")


def resolve_ot_solver(name: str, device) -> str:
    """The JAX package's OT solver name -> the port's: 'xla' (the
    reference-parity loop) -> 'torch', the plain PyTorch loop; 'pallas' ->
    'kernel', K1 with its final step; 'auto' -> 'kernel' on a CUDA device and
    'torch' on the CPU."""
    if name == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "torch"
    if name not in OT_SOLVERS:
        raise ValueError(f"unknown OT solver {name!r}: use xla, pallas or auto")
    return OT_SOLVERS[name]


def batchify(dataset: dict, batch_size: int):
    """Yield (pids, papers) chunks (reference utils.batchify)."""
    pids, batch = [], []
    for pid, data in dataset.items():
        pids.append(pid)
        batch.append(data)
        if len(batch) == batch_size:
            yield pids, batch
            pids, batch = [], []
    if batch:
        yield pids, batch


def _sub_state(state_dict: dict, prefix: str) -> dict:
    """The entries under `prefix`, with it taken off."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _to_device(arr: np.ndarray, device, long: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t.long() if long else t


def _pad_rows(rows: list[list[int]], pad_id: int, multiple: int = 64):
    """Token id lists -> (ids, mask) padded to the longest rounded up to
    `multiple` (the JAX package's shapes, so both see the same padding)."""
    max_len = -(-max(len(r) for r in rows) // multiple) * multiple
    ids = np.full((len(rows), max_len), pad_id, np.int32)
    attn = np.zeros((len(rows), max_len), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        attn[i, : len(r)] = 1
    return ids, attn


def _require_entities(batch_papers: list[dict]) -> None:
    if "ENTITIES" not in batch_papers[0]:
        raise ValueError("No NER data for input; place entities at "
                         "{dataset}-ner.jsonl")


def _split_sents(batch_papers: list[dict]):
    sents, splits, cur = [], [], 0
    for p in batch_papers:
        sents.extend(p["ABSTRACT"])
        cur += len(p["ABSTRACT"])
        splits.append(cur)
    return sents, splits


def _cosine_max(x, y) -> float:
    xn = x / np.clip(np.linalg.norm(x, axis=1, keepdims=True), 1e-9, None)
    yn = y / np.clip(np.linalg.norm(y, axis=1, keepdims=True), 1e-9, None)
    return float(np.max(xn @ yn.T))


class SimilarityModel(metaclass=ABCMeta):
    """Abstract paper-similarity model (plugin API).

    encoding_type: 'abstract' (one vector/doc), 'sentence' (one per sentence),
    'sentence-entity' (sentences + entity vectors appended).
    """

    ENCODING_TYPES = ("abstract", "sentence", "sentence-entity")

    def __init__(self, name: str, encoding_type: str, batch_size: int = 8,
                 device="cuda"):
        if encoding_type not in SimilarityModel.ENCODING_TYPES:
            raise ValueError(f"unknown encoding_type {encoding_type!r}")
        self.name = name
        self.encoding_type = encoding_type
        self.batch_size = batch_size
        self.device = require_device(device)
        self.cache = None

    @abstractmethod
    def encode(self, batch_papers: list[dict]):
        """-> list of per-paper encodings (np arrays)."""
        raise NotImplementedError

    @abstractmethod
    def get_similarity(self, x, y) -> float:
        """Similarity between two encodings (higher = more similar)."""
        raise NotImplementedError

    def get_similarities(self, query_enc, cand_encs: list) -> np.ndarray:
        """Batched scoring; default falls back to the per-pair API."""
        return np.asarray([self.get_similarity(query_enc, c) for c in cand_encs])

    # ---- encodings cache (h5py contract, utils/models.py:68-122) ----
    def set_encodings_cache(self, cache_filename: str):
        import h5py
        if self.cache is not None:
            # close the live handle first: a second same-process open of the
            # same file trips HDF5's write lock, and the 'w' fallback below
            # would then truncate every cached encoding
            try:
                self.cache.close()
            except Exception:
                pass
            self.cache = None
        try:
            self.cache = h5py.File(cache_filename, "a")
        except Exception:
            log.warning("could not open encodings cache %s; OVERWRITING it",
                        cache_filename)
            self.cache = h5py.File(cache_filename, "w")

    def cache_encodings(self, batch_pids, batch_papers):
        if self.cache is None:
            raise RuntimeError("cache is not set")
        encodings = self.encode(batch_papers)
        for i, pid in enumerate(batch_pids):
            self.cache.create_dataset(name=pid, data=np.asarray(encodings[i]))
        return encodings

    def get_encoding(self, pids: list, dataset) -> dict:
        uncached = [p for p in pids if self.cache is None or p not in self.cache]
        out = {}
        if self.cache is not None:
            for pid in set(pids).difference(uncached):
                out[pid] = np.array(self.cache.get(pid))
        for bpids, bpapers in batchify({p: dataset.get(p) for p in uncached},
                                       self.batch_size):
            encs = (self.cache_encodings(bpids, bpapers) if self.cache is not None
                    else self.encode(bpapers))
            out.update({pid: np.asarray(encs[i]) for i, pid in enumerate(bpids)})
        return out

    # ---- facet filtering (utils/models.py:127-163) ----
    def get_faceted_encoding(self, unfaceted_encoding, facet: str, input_data: dict):
        if self.encoding_type == "abstract":
            return unfaceted_encoding
        labels = ["background" if lab == "objective_label" else lab[: -len("_label")]
                  for lab in input_data["FACETS"]]
        facet_ids = [i for i, lab in enumerate(labels) if lab == facet]
        if self.encoding_type == "sentence":
            filtered = facet_ids
        else:
            ner_cur = len(labels)
            ner_ids = []
            for i, sent_ners in enumerate(input_data["ENTITIES"]):
                if i in facet_ids:
                    ner_ids += list(range(ner_cur, ner_cur + len(sent_ners)))
                ner_cur += len(sent_ners)
            filtered = facet_ids + ner_ids
        # encode() keeps only a PREFIX of the combined [sents..., ents...]
        # rows (max_sents cap + 500-token truncation drop trailing rows --
        # the reference has no such cap, so this clamp is port-specific):
        # rows past what was actually encoded don't exist
        n_rows = len(unfaceted_encoding)
        filtered = [i for i in filtered if i < n_rows]
        return unfaceted_encoding[filtered]

    def __del__(self):
        if getattr(self, "cache", None) is not None:
            try:
                self.cache.close()
            except Exception:
                pass


def _run_info(run_dir: str, model_version: str):
    """(RunConfig, BertConfig, state_dict) of one of the port's training runs."""
    from ..utils.checkpoint import restore_params
    rc = RunConfig.from_run_info(os.path.join(run_dir, "run_info.json"))
    path = os.path.join(run_dir, f"model_{model_version}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the port reads its own checkpoints "
            "(model_{version}.pt); orbax trees of the JAX package need JAX")
    bc = (BertConfig(**rc.extra["bert_config"])
          if "bert_config" in rc.extra else BertConfig())
    return rc, bc, restore_params(path)


# ----------------------------------------------------------------------
class AspireSimilarityModel(SimilarityModel):
    """Multi-vector contextual-sentence model (ts/otAspire checkpoints).

    agg: 'ot' (otAspire Sinkhorn), 'l2max' (tsAspire single match),
    'jointsm' (poly-encoder) or 'cosine_max' (sentence-transformer style).
    state_dict: the ConSentEncoder's (names "bert....").
    ot_solver: 'xla' (the plain PyTorch loop, reference parity), 'pallas'
    (K1 with its final step on a CUDA device) or 'auto'.
    attention_impl / ffn_impl / pool_impl: the encoder's backends ('auto':
    the CUDA kernels on a CUDA device; 'naive': plain PyTorch).
    """

    ENCODER = ConSentEncoder

    def __init__(self, name: str, bert_config: BertConfig, state_dict: dict,
                 tokenizer, agg: str = "ot", encoding_type: str = "sentence",
                 max_sents: int = 24, batch_size: int = 8,
                 ot_temp: float = 1.0, blur: float = 0.05, scaling: float = 0.9,
                 compute_dtype=torch.float32, ot_solver: str = "xla",
                 seq_buckets: tuple[int, ...] | None = None, device="cuda",
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 pool_impl: str = "auto"):
        super().__init__(name=name, encoding_type=encoding_type,
                         batch_size=batch_size, device=device)
        if agg not in AGGS:
            raise ValueError(f"unknown agg {agg}")
        self.bert_config = bert_config
        # seq_buckets, e.g. (128, 256, 384, 512): each encode batch runs at
        # the smallest bucket covering its longest sequence instead of a
        # fixed 512 (build-index --seq-buckets sorts docs by length first so
        # batches are homogeneous)
        self.seq_buckets = tuple(sorted(seq_buckets)) if seq_buckets else None
        # compute_dtype=bf16: encoder activations in bf16 (weights stay f32,
        # reps come back f32) -- opt-in for bulk corpus encoding; the default
        # f32 keeps encode parity with the reference's torch f32 path
        self.encoder = self.ENCODER(
            bert_config, max_sents=max_sents, dtype=compute_dtype,
            device=self.device, attention_impl=attention_impl,
            ffn_impl=ffn_impl, pool_impl=pool_impl).eval()
        self.encoder.load_state_dict(state_dict)
        self.tokenizer = tokenizer
        self.max_sents = max_sents
        self.agg = agg
        self.ot_temp = ot_temp
        self.blur = blur
        self.scaling = scaling
        self.ot_solver = resolve_ot_solver(ot_solver, self.device)

    # -- constructors --
    @classmethod
    def from_hf_dir(cls, name: str, model_dir: str, device="cuda", **kw):
        """Load a local HF aspire checkpoint directory."""
        from ..models.convert import load_hf_dir
        ckpt = load_hf_dir(model_dir, device)
        return cls(name=name, bert_config=ckpt.config,
                   state_dict=ckpt.bert_state_dict("bert."),
                   tokenizer=ckpt.tokenizer, device=device, **kw)

    @classmethod
    def from_trained(cls, name: str, run_dir: str, tokenizer,
                     model_version: str = "cur_best", **kw):
        """Load one of the port's own training runs (run_info.json +
        model_{model_version}.pt)."""
        rc, bc, sd = _run_info(run_dir, model_version)
        agg = "ot" if rc.model.score_aggregation == "l2wasserstein" else "l2max"
        kw.setdefault("agg", agg)
        kw.setdefault("ot_temp", rc.model.sent_sm_temp)
        kw.setdefault("blur", rc.model.geoml_blur)
        kw.setdefault("scaling", rc.model.geoml_scaling)
        kw.setdefault("max_sents", rc.model.max_sents)
        return cls(name=name, bert_config=bc,
                   state_dict=_sub_state(sd, "encoder."), tokenizer=tokenizer,
                   **kw)

    # -- API --
    def _prep(self, batch_papers):
        # one sequence length (the reference's own 500-token cap rounds to
        # 512), as the JAX package encodes
        seq_len = min(512, self.bert_config.max_position_embeddings)
        return prepare_abstracts(batch_papers, self.tokenizer,
                                 max_sents=self.max_sents, seq_len=seq_len)

    def _bucketed_arrays(self, fb):
        """A featurized batch on the device, trimmed to its seq bucket
        (identity when off).  Attention masking makes the trailing pad
        columns inert, so the reps are those at 512 up to float reduction
        order."""
        t, a, s = fb.token_ids, fb.attn_mask, fb.sent_ids
        if self.seq_buckets is not None:
            m = int(fb.attn_mask.sum(axis=1).max())
            # smallest bucket covering the batch; a batch LONGER than every
            # bucket keeps its full length (trimming there would cut real
            # tokens, not pad)
            b = next((b for b in self.seq_buckets if m <= b), t.shape[1])
            if b < t.shape[1]:
                t, a, s = t[:, :b], a[:, :b], s[:, :b]
        return (_to_device(t, self.device, long=True),
                _to_device(a, self.device),
                _to_device(s, self.device, long=True))

    def _sentence_reps(self, fb) -> torch.Tensor:
        with torch.no_grad():
            _, sents = self.encoder(*self._bucketed_arrays(fb))
        return sents.float()

    def encode(self, batch_papers: list[dict]):
        fb = self._prep(batch_papers)
        sents = self._sentence_reps(fb).cpu().numpy()
        return [sents[i, : fb.abs_lens[i]] for i in range(fb.batch)]

    def encode_quantized(self, batch_papers: list[dict]):
        """Encode + per-sentence symmetric int8 quantization ON DEVICE.

        The quantisation runs on the encoder's device and the host downloads
        1 byte per element (+1 f32 scale per sentence) instead of 4.
        Semantics match index.dense.build_dense_index(dtype='int8'): scale =
        max|x|/127 per sentence (1.0 for all-zero rows), round-half-even.

        Returns a list of (xi int8 [len, d], scales f32 [len]) per paper;
        feed to index.dense.build_dense_index_prequantized.
        """
        from ..index.dense import quantize_sentences
        fb = self._prep(batch_papers)
        xi, sc = quantize_sentences(self._sentence_reps(fb))
        xi, sc = xi.cpu().numpy(), sc.cpu().numpy()
        return [(xi[i, : fb.abs_lens[i]], sc[i, : fb.abs_lens[i]])
                for i in range(fb.batch)]

    def _pack(self, encs: list[np.ndarray], smax: int) -> MultiVec:
        k = len(encs)
        d = encs[0].shape[-1]
        out = np.zeros((k, smax, d), np.float32)
        lens = np.zeros((k,), np.int32)
        for i, e in enumerate(encs):
            n = min(len(e), smax)
            out[i, :n] = e[:n]
            lens[i] = n
        return MultiVec(embed=_to_device(out, self.device),
                        lens=_to_device(lens, self.device, long=True))

    def _pair_scores(self, q: MultiVec, c: MultiVec) -> torch.Tensor:
        if self.agg == "ot":
            # per-pair annealing start: parity with the reference's 1x1
            # evaluate.py scoring, and scores don't depend on chunking
            sims, _ = wasserstein_dist(q, c, blur=self.blur,
                                       scaling=self.scaling, temp=self.ot_temp,
                                       return_pair_sims=True, diameter="pair",
                                       solver=self.ot_solver)
        elif self.agg == "l2max":
            sims, _ = l2max_dist(q, c, return_pair_sims=True)
        elif self.agg == "jointsm":
            neg, _ = jointsm_dist(q, c, return_pair_sims=True)
            sims = -neg  # poly-encoder returns negated summed score
        else:  # cosine_max
            require_fp32_matmul()
            qn = q.embed / torch.linalg.vector_norm(
                q.embed, dim=-1, keepdim=True).clamp_min(1e-9)
            cn = c.embed / torch.linalg.vector_norm(
                c.embed, dim=-1, keepdim=True).clamp_min(1e-9)
            sims_mat = torch.einsum("bqd,bcd->bqc", qn, cn)
            mask = q.sent_mask()[:, :, None] * c.sent_mask()[:, None, :]
            sims = torch.where(mask > 0, sims_mat,
                               torch.full_like(sims_mat, -torch.inf)
                               ).amax(dim=(1, 2))
        return sims

    # Deep candidate pools (TRECCOVID-RF pools reach thousands) are scored in
    # chunks so one call never holds a [pool, smax, d] monolith.  Chunk size
    # and sentence count follow the JAX package's ladders; a chunk is one
    # solve (one K1 launch with ot_solver='pallas' on a CUDA device).
    SCORE_CHUNKS = (64, 256, 1024)

    def get_similarities(self, query_enc, cand_encs: list) -> np.ndarray:
        if not cand_encs:
            return np.zeros((0,), np.float32)
        # one sentence bucket: max_sents, or past it the next multiple of 8
        smax = max(len(query_enc), max(len(c) for c in cand_encs), 2)
        smax = self.max_sents if smax <= self.max_sents else -(-smax // 8) * 8
        n = len(cand_encs)
        out = np.empty((n,), np.float32)
        start = 0
        # the query is packed and copied once, then repeated on the device
        q1 = self._pack([query_enc], smax)
        with torch.no_grad():
            while start < n:
                rem = n - start
                size = next((c for c in self.SCORE_CHUNKS if rem <= c),
                            self.SCORE_CHUNKS[-1])
                take = min(rem, size)
                chunk = list(cand_encs[start:start + take])
                if take < size:  # pad with the last candidate to the ladder
                    chunk += [chunk[-1]] * (size - take)
                q = MultiVec(embed=q1.embed.expand(size, -1, -1),
                             lens=q1.lens.expand(size))
                c = self._pack(chunk, smax)
                out[start:start + take] = \
                    self._pair_scores(q, c).float().cpu().numpy()[:take]
                start += take
        return out

    def get_similarity(self, x, y) -> float:
        return float(self.get_similarities(np.asarray(x), [np.asarray(y)])[0])


class AspireNERSimilarityModel(AspireSimilarityModel):
    """Entities appended as extra sentences (AspireNER, utils/models.py:211-233)."""

    def __init__(self, *args, **kw):
        # entity rows ride after the sentence rows, so facet filtering must
        # take the sentence-entity branch for ANY construction path
        kw.setdefault("encoding_type", "sentence-entity")
        super().__init__(*args, **kw)

    @staticmethod
    def _with_entity_sents(batch_papers: list[dict]) -> list[dict]:
        _require_entities(batch_papers)
        with_ner = []
        for sample in batch_papers:
            ners = [e for sent in sample["ENTITIES"] for e in sent]
            with_ner.append({"TITLE": sample["TITLE"],
                             "ABSTRACT": list(sample["ABSTRACT"]) + ners})
        return with_ner

    def encode(self, batch_papers: list[dict]):
        return super().encode(self._with_entity_sents(batch_papers))

    def encode_quantized(self, batch_papers: list[dict]):
        # the entity rows are ordinary extra sentences for this family, so the
        # device-quantized path sees them through the same rewrite encode()
        # uses: int8 and float indexes then hold the same rows
        return super().encode_quantized(self._with_entity_sents(batch_papers))


class AspireContextNERSimilarityModel(AspireSimilarityModel):
    """Contextual entity-span model (AspireContextNER, utils/models.py:607-734,
    with the AspireConSenContextual encoder, :413-507).

    Each NER entity is represented as the MEAN OF ITS TOKEN STATES INSIDE THE
    SENTENCE CONTEXT -- not re-encoded as a standalone sentence (that is
    AspireNERSimilarityModel / reference AspireNER).  Entity reps are appended
    after the sentence reps and OT scoring runs over the combined set.
    Entities whose tokenization can't be located in the sentence (different
    extraction tokenizer) or that fall past the 500-token truncation are
    skipped, and the facet filter drops them symmetrically.
    """

    # the same parameters as ConSentEncoder, so any aspire checkpoint loads
    ENCODER = ConSentSpanEncoder

    def __init__(self, *args, **kw):
        kw.setdefault("encoding_type", "sentence-entity")
        super().__init__(*args, **kw)

    def encode(self, batch_papers: list[dict]):
        _require_entities(batch_papers)
        seq_len = min(512, self.bert_config.max_position_embeddings)
        fb, docs = prepare_abstracts(batch_papers, self.tokenizer,
                                     max_sents=self.max_sents,
                                     seq_len=seq_len, return_docs=True)
        spans = ner_token_spans(batch_papers, self.tokenizer, docs)
        mask = spans_to_mask(spans, fb.seq_len)
        with torch.no_grad():
            _, sents, ents = self.encoder(
                _to_device(fb.token_ids, self.device, long=True),
                _to_device(fb.attn_mask, self.device),
                _to_device(fb.sent_ids, self.device, long=True),
                _to_device(mask, self.device))
        sents = sents.float().cpu().numpy()
        ents = ents.float().cpu().numpy()
        out = []
        for i in range(fb.batch):
            rows = [sents[i, : fb.abs_lens[i]]]
            valid = [e for e, s in enumerate(spans[i]) if s]
            if valid:
                rows.append(ents[i, valid])
            out.append(np.concatenate(rows, axis=0))
        return out

    def encode_quantized(self, batch_papers: list[dict]):
        """int8 rows for the combined sentence+span reps, quantized on the
        host with the exact build_dense_index(dtype='int8') scheme (scale =
        max|x|/127 per row, 1.0 for all-zero rows, round-half-even), so int8
        and float indexes stay semantically equal."""
        out = []
        for reps in self.encode(batch_papers):
            sc = np.abs(reps).max(axis=1) / 127.0
            sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
            xi = np.clip(np.rint(reps / sc[:, None]), -127, 127).astype(np.int8)
            out.append((xi, sc))
        return out

    def get_faceted_encoding(self, unfaceted_encoding, facet: str,
                             input_data: dict):
        """Filter to facet sentences + their (encodable) entities.

        Re-derives entity validity so ENTITY positions line up with the rows
        actually encoded (reference :708-734, with every entity consuming one
        validity slot, as the JAX package has it)."""
        _, docs = prepare_abstracts([input_data], self.tokenizer,
                                    max_sents=self.max_sents, return_docs=True)
        valid = [len(s) > 0
                 for s in ner_token_spans([input_data], self.tokenizer, docs)[0]]
        filtered, eid = [], 0
        for sent_ners in input_data["ENTITIES"]:
            keep = []
            for ent in sent_ners:
                if eid < len(valid) and valid[eid]:
                    keep.append(ent)
                eid += 1
            filtered.append(keep)
        data = {**{k: v for k, v in input_data.items() if k != "ENTITIES"},
                "ENTITIES": filtered}
        return super().get_faceted_encoding(unfaceted_encoding, facet, data)


class SbertSimilarityModel(SimilarityModel):
    """Mean-pool sentence-transformer baselines (SentenceModel,
    utils/models.py:379-410): per-sentence masked mean pooling over final
    hidden states, cosine max-sim scoring.

    Loads a local HF checkpoint directory of the BERT, RoBERTa or MPNet
    family (models/convert.load_hf_dir; the JAX package runs the last two
    through `transformers` on the CPU) and encodes in f32 on `device`: BERT
    and RoBERTa through K2 and K3, MPNet through K3 and its own attention
    (models/mpnet.py).  attention_impl / ffn_impl: the encoder's routes
    ('naive' is the plain route).
    """

    # reference hub ids for the paper's three sbert baselines; pass a local
    # clone of one of these as weights_dir
    MODEL_PATHS = {
        "sbtinybertsota": "paraphrase-TinyBERT-L6-v2",
        "sbrobertanli": "nli-roberta-base-v2",
        "sbmpnet1B": "sentence-transformers/all-mpnet-base-v2",
    }

    def __init__(self, name: str, weights_dir: str, batch_size: int = 8,
                 max_toks: int = 512, device="cuda",
                 attention_impl: str = "auto", ffn_impl: str = "auto"):
        super().__init__(name=name, encoding_type="sentence",
                         batch_size=batch_size, device=device)
        from ..models.convert import load_hf_dir
        ckpt = load_hf_dir(weights_dir, device)
        self.tokenizer = ckpt.tokenizer
        self.max_toks = max_toks  # multiple of 64 (rows pad to 64 below)
        self.bert = ckpt.encoder_model(attention_impl, ffn_impl)

    def _mean_pool(self, ids: np.ndarray, attn: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            a = _to_device(attn, self.device)
            last, _ = self.bert(_to_device(ids, self.device, long=True), a)
            m = a[:, :, None].float()
            return ((last * m).sum(1) / m.sum(1).clamp_min(1e-9)).cpu().numpy()

    def encode(self, batch_papers: list[dict]):
        sents, splits = _split_sents(batch_papers)
        # what HF's tokenizer(sents, truncation=True, max_length=max_toks)
        # gives: [CLS] + the first max_toks - 2 pieces + [SEP]
        rows = [self.tokenizer.build_inputs_with_special_tokens(
            self.tokenizer.encode(s)[: self.max_toks - 2].tolist())
            for s in sents]
        ids, am = _pad_rows(rows, self.tokenizer.pad_token_id)
        return np.split(self._mean_pool(ids, am), splits[:-1])

    def get_similarity(self, x, y) -> float:
        return _cosine_max(x, y)


class TrainedSentSimilarityModel(SimilarityModel):
    """Per-sentence encoder eval model (cosentbert / ictsentbert / SimCSE).

    The reference wraps the trained towers as SentenceTransformers and
    scores with cosine max-sim (TrainedSentModel, utils/models.py:570-604);
    the SimCSE baselines encode each sentence and return `pooler_output`
    (SimCSE, utils/models.py:322-357).  Each abstract sentence is encoded
    separately: CLS rep by default, or tanh(dense(CLS)) when
    `pooler_state_dict` is given.  state_dict: the BertModel's.
    """

    def __init__(self, name: str, bert_config: BertConfig, state_dict: dict,
                 tokenizer, batch_size: int = 8, max_toks: int = 500,
                 pooler_state_dict: dict | None = None, device="cuda"):
        super().__init__(name=name, encoding_type="sentence",
                         batch_size=batch_size, device=device)
        self.tokenizer = tokenizer
        self.max_toks = max_toks
        self.bert = BertModel(bert_config, device=self.device).eval()
        self.bert.load_state_dict(state_dict)
        self.pooler = None
        if pooler_state_dict is not None:
            self.pooler = BertPooler(bert_config, device=self.device).eval()
            self.pooler.load_state_dict(pooler_state_dict)

    @classmethod
    def from_hf_dir(cls, name: str, model_dir: str, device="cuda", **kw):
        """SimCSE-style per-sentence pooler encoder from a local HF dir."""
        from ..models.convert import load_hf_dir
        ckpt = load_hf_dir(model_dir, device)
        pooler = ckpt.pooler_state_dict()
        if pooler is None:
            raise ValueError(
                f"{model_dir} has no pooler head; SimCSE encode returns "
                "pooler_output (reference utils/models.py:330-357)")
        return cls(name=name, bert_config=ckpt.config,
                   state_dict=ckpt.bert_state_dict(), tokenizer=ckpt.tokenizer,
                   pooler_state_dict=pooler, device=device, **kw)

    def encode(self, batch_papers: list[dict]):
        sents, splits = _split_sents(batch_papers)
        rows = [self.tokenizer.build_inputs_with_special_tokens(
            self.tokenizer.convert_tokens_to_ids(
                self.tokenizer.tokenize(s)[: self.max_toks]))
            for s in sents]
        ids, attn = _pad_rows(rows, self.tokenizer.pad_token_id)
        with torch.no_grad():
            last, _ = self.bert(_to_device(ids, self.device, long=True),
                                _to_device(attn, self.device))
            reps = self.pooler(last) if self.pooler is not None else last[:, 0, :]
        return np.split(reps.float().cpu().numpy(), splits[:-1])

    def get_similarity(self, x, y) -> float:
        return _cosine_max(x, y)


class ClsSimilarityModel(SimilarityModel):
    """Whole-abstract CLS encoders (specter/cospecter style); -L2 similarity.

    layer_mix: None -> plain final-layer CLS (BertMLM, utils/models.py:237-321);
    a [13] weight vector -> softmax scalar mix (cospecter bi-encoder).
    state_dict: the BertModel's.
    """

    def __init__(self, name: str, bert_config: BertConfig, state_dict: dict,
                 tokenizer, layer_mix: np.ndarray | None = None,
                 encoding_type: str = "abstract", batch_size: int = 8,
                 max_toks: int = 500, device="cuda"):
        super().__init__(name=name, encoding_type=encoding_type,
                         batch_size=batch_size, device=device)
        self.tokenizer = tokenizer
        self.max_toks = max_toks
        if layer_mix is not None:
            self.encoder = BiEncoder(bert_config, device=self.device).eval()
            self.encoder.load_state_dict({
                **{"bert." + k: v for k, v in state_dict.items()},
                "layer_weights": torch.as_tensor(np.asarray(layer_mix,
                                                            np.float32))})
        else:
            self.encoder = BertModel(bert_config, device=self.device).eval()
            self.encoder.load_state_dict(state_dict)
        self.layer_mix = layer_mix is not None

    @classmethod
    def from_hf_dir(cls, name: str, model_dir: str, device="cuda", **kw):
        from ..models.convert import load_hf_dir
        ckpt = load_hf_dir(model_dir, device)
        return cls(name=name, bert_config=ckpt.config,
                   state_dict=ckpt.bert_state_dict(), tokenizer=ckpt.tokenizer,
                   device=device, **kw)

    def _texts(self, batch_papers):
        return [p["TITLE"] + " [SEP] " + " ".join(p["ABSTRACT"])
                for p in batch_papers]

    def encode(self, batch_papers: list[dict]):
        rows = [self.tokenizer.build_inputs_with_special_tokens(
            self.tokenizer.convert_tokens_to_ids(
                self.tokenizer.tokenize(t)[: self.max_toks]))
            for t in self._texts(batch_papers)]
        ids, attn = _pad_rows(rows, self.tokenizer.pad_token_id)
        with torch.no_grad():
            ids = _to_device(ids, self.device, long=True)
            attn = _to_device(attn, self.device)
            if self.layer_mix:
                cls = self.encoder(ids, attn)
            else:
                cls = self.encoder(ids, attn)[0][:, 0, :]
        return list(cls.float().cpu().numpy())

    def get_similarity(self, x, y) -> float:
        return -float(np.linalg.norm(np.asarray(x) - np.asarray(y)))

    def get_similarities(self, query_enc, cand_encs: list) -> np.ndarray:
        c = np.stack([np.asarray(e) for e in cand_encs])
        return -np.linalg.norm(c - np.asarray(query_enc)[None], axis=1)


class ClsNERSimilarityModel(ClsSimilarityModel):
    """CLS encoder with entities appended to the abstract text (BertNER)."""

    def _texts(self, batch_papers):
        out = []
        for p in batch_papers:
            base = p["TITLE"] + " [SEP] " + " ".join(p["ABSTRACT"])
            ents = ". ".join(e for sent in p["ENTITIES"] for e in sent)
            out.append(base + " " + ents + ".")
        return out


# ----------------------------------------------------------------------
HF_DIR_MODELS = {"aspire_compsci", "aspire_biomed", "aspire_ner_compsci",
                 "aspire_ner_biomed", "aspire_context_ner_compsci",
                 "aspire_context_ner_biomed", "sbtinybertsota", "sbrobertanli",
                 "sbmpnet1B", "specter", "supsimcse", "unsupsimcse",
                 "specter_ner"}
RUN_DIR_MODELS = {"cospecter", "tsaspire", "otaspire", "sbalisentbienc",
                  "miswordbienc", "miswordabsbienc", "miswordpolyenc",
                  "cosentbert", "ictsentbert"}


def get_model(model_name: str, trained_model_path: str | None = None,
              weights_dir: str | None = None, tokenizer=None,
              batch_size: int = 8, ot_solver: str = "xla",
              device="cuda") -> SimilarityModel:
    """Factory keyed by the reference model names (utils/models.py:738-768).

    HF-hub-named models need `weights_dir` pointing at a local checkpoint
    directory; trained models need `trained_model_path` (one of the port's
    run directories) and a tokenizer.  ot_solver: 'xla' (reference parity),
    'pallas' (K1 on a CUDA device) or 'auto'.
    """
    ot_models = {"aspire_compsci", "aspire_biomed"}
    ner_models = {"aspire_ner_compsci", "aspire_ner_biomed"}
    if model_name in HF_DIR_MODELS and not weights_dir:
        raise ValueError(f"{model_name} needs a local weights_dir")
    if model_name in RUN_DIR_MODELS and (not trained_model_path
                                         or tokenizer is None):
        raise ValueError(f"{model_name} needs a run directory "
                         "(trained_model_path) and a tokenizer")
    kw = {"batch_size": batch_size, "device": device}
    akw = {**kw, "ot_solver": ot_solver}  # Aspire multi-vector models only
    if model_name in ot_models:
        return AspireSimilarityModel.from_hf_dir(model_name, weights_dir,
                                                 agg="ot", **akw)
    if model_name in ner_models:
        return AspireNERSimilarityModel.from_hf_dir(model_name, weights_dir,
                                                    agg="ot", **akw)
    if model_name in {"aspire_context_ner_compsci", "aspire_context_ner_biomed"}:
        return AspireContextNERSimilarityModel.from_hf_dir(
            model_name, weights_dir, agg="ot", **akw)
    if model_name in {"sbtinybertsota", "sbrobertanli", "sbmpnet1B"}:
        return SbertSimilarityModel(model_name, weights_dir, **kw)
    if model_name == "specter":
        return ClsSimilarityModel.from_hf_dir(model_name, weights_dir, **kw)
    if model_name in {"supsimcse", "unsupsimcse"}:
        # per-SENTENCE pooler_output reps, max-cosine ranking (reference
        # SimCSE utils/models.py:322-357 + the sent rank path)
        return TrainedSentSimilarityModel.from_hf_dir(model_name, weights_dir,
                                                      **kw)
    if model_name == "specter_ner":
        return ClsNERSimilarityModel.from_hf_dir(model_name, weights_dir, **kw)
    if model_name == "cospecter":
        _, bc, sd = _run_info(trained_model_path, "cur_best")
        return ClsSimilarityModel(
            name=model_name, bert_config=bc,
            state_dict=_sub_state(sd, "encoder.bert."), tokenizer=tokenizer,
            layer_mix=sd["encoder.layer_weights"].numpy(), **kw)
    if model_name in {"tsaspire", "otaspire", "sbalisentbienc", "miswordbienc",
                      "miswordabsbienc", "miswordpolyenc"}:
        if model_name == "miswordpolyenc":
            akw.setdefault("agg", "jointsm")
        return AspireSimilarityModel.from_trained(model_name, trained_model_path,
                                                  tokenizer, **akw)
    if model_name in {"cosentbert", "ictsentbert"}:
        _, bc, sd = _run_info(trained_model_path, "cur_best")
        # the ICT query tower scores at test time
        tower = "sent_encoder." if model_name == "ictsentbert" else "encoder."
        return TrainedSentSimilarityModel(
            name=model_name, bert_config=bc, state_dict=_sub_state(sd, tower),
            tokenizer=tokenizer, **kw)
    raise ValueError(f"Unknown model: {model_name}")
