"""Command-line interface of the port (counterpart of aspire_tpu/cli.py): the
same subcommands, flags, defaults and files in and out, on CUDA devices.

  python -m aspire_tpu_torch train        --config cfg.json --train t.jsonl --dev d.jsonl --out run/
  python -m aspire_tpu_torch build-index  --run-dir run/ --corpus abstracts.jsonl --out idx/
  python -m aspire_tpu_torch rank         --index idx/ --run-dir run/ --dataset-dir d/ --dataset name --out res/
  python -m aspire_tpu_torch evaluate     --dataset-dir d/ --dataset name --model aspire_compsci --results res/
  python -m aspire_tpu_torch compare      --results-a a.csv --results-b b.csv
  python -m aspire_tpu_torch preprocess   gorc --in-path corpus/ --out-path triples/ --extra '{"processes": 4}'
  python -m aspire_tpu_torch ner          --abstracts abstracts-x.jsonl --out x-ner.jsonl

Every subcommand but `compare` takes `--device` (default `cuda`; without CUDA
it raises unless `--device cpu` is given).  `preprocess` and `ner` run on the
host; only a `preprocess` action given an `aligner_run_dir` (in `--extra`)
encodes, on that device.  Tokenizers are the port's own
(text/fast.FastWordPiece over a local vocab.txt) and HF weights are read from
local directories without `transformers` (models/convert.load_hf_dir).

Several cards (parallel/mesh.py: one process a rank): `train --num-devices N`
spawns N data-parallel ranks and `rank --n-shards N` N index-shard ranks, one
a card over NCCL (`--device cpu`: gloo ranks on the CPU).  `--num-processes P
--coordinator HOST:PORT --process-id I` joins P machines, each running the
same command with its own id and its N ranks (N = 1 without the flags above).
Every rank reads the same inputs; rank 0 alone writes (the run directory, the
rankings, an h5 `--cache`).  `build-index --n-shards N` packs the index for N
shard ranks.  `--fast-rng` (the TPU's hardware bit generator) is refused;
`--fast-tokenizer` is accepted and changes nothing (the native tokenizer is
the only one).
"""
from __future__ import annotations

import argparse
import json
import logging
import os


def _setup_logging(args):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        filename=getattr(args, "log_fname", None) or None,
    )


def _device(args):
    from .core.types import require_device
    return require_device(args.device)


def _refuse_fast_rng(args) -> None:
    if getattr(args, "fast_rng", False):
        raise SystemExit("--fast-rng (the TPU's hardware bit generator) is "
                         "dropped in the port: dropout masks are Philox words "
                         "keyed on position")


def _on_ranks(args, body, n_local: int, mesh_of):
    """body(args, None) in this process, or body(args, mesh) on the ranks the
    flags ask for: `n_local` ranks on this machine (one a card over NCCL;
    gloo ranks on the CPU with --device cpu), on each of --num-processes
    machines met at --coordinator.  Returns what body returns in this
    process; None after ranks (their files are the result)."""
    from .parallel.mesh import run_ranks
    hosts = 1 if args.num_processes is None else args.num_processes
    if n_local < 1 or hosts < 1:
        raise SystemExit("--num-devices, --n-shards and --num-processes count "
                         "ranks and machines: at least 1")
    if hosts == 1 and (args.coordinator is not None
                       or args.process_id is not None):
        raise SystemExit("--coordinator and --process-id join several "
                         "machines: they need --num-processes above 1")
    if hosts > 1 and (args.coordinator is None or args.process_id is None):
        raise SystemExit("--num-processes needs --coordinator (rank 0's "
                         "host:port) and this machine's --process-id")
    if hosts * n_local == 1:
        return body(args, None)
    run_ranks(_rank_body, n_local, body, mesh_of, args, device=args.device,
              coordinator=args.coordinator if hosts > 1 else None,
              num_processes=hosts, process_id=args.process_id or 0)
    return None


def _rank_body(body, mesh_of, args) -> None:
    _setup_logging(args)
    mesh = mesh_of()
    args.device = str(mesh.device)
    body(args, mesh)


def _tokenizer(path: str):
    from .text.fast import FastWordPiece
    return FastWordPiece.from_dir(path)


def _bert_modules(model):
    """The BertModel(s) of a model built by build_model, for --init-hf-dir."""
    if hasattr(model, "sent_encoder"):                    # ictsentbert
        return [model.sent_encoder, model.context_encoder]
    enc = model.encoder
    return [enc.bert] if hasattr(enc, "bert") else [enc]


def cmd_train(args):
    """train: in this process, or on --num-devices data ranks (times
    --num-processes machines)."""
    from .parallel.mesh import make_mesh
    _refuse_fast_rng(args)
    return _on_ranks(args, _train,
                     1 if args.num_devices is None else args.num_devices,
                     make_mesh)


def _train(args, mesh):
    import dataclasses

    import torch

    from .core.config import RunConfig
    from .data.readers import TripleStream, dev_batches
    from .models.bert import BertConfig
    from .models.doc_models import build_model
    from .train.trainer import Trainer

    device = _device(args)
    cfg = RunConfig.from_json(args.config)
    tok_src = args.tokenizer or cfg.model.base_pt_layer
    tokenizer = _tokenizer(tok_src)
    ckpt = None
    if args.init_hf_dir:
        from .models.convert import load_hf_dir
        ckpt = load_hf_dir(args.init_hf_dir, device)
    bert_config = BertConfig()  # full-size; tiny override for smoke tests
    if args.tiny:
        bert_config = BertConfig.tiny(vocab_size=tokenizer.vocab_size)
    if ckpt is not None:
        # the encoder takes the checkpoint's architecture (its weights must
        # load into it)
        bert_config = ckpt.config
    # position ids past the table produce garbage embeddings (NaN losses),
    # so refuse the config instead of training nonsense
    if args.seq_len > bert_config.max_position_embeddings:
        raise SystemExit(f"--seq-len {args.seq_len} exceeds the encoder's "
                         "max_position_embeddings="
                         f"{bert_config.max_position_embeddings}")
    # persist the encoder architecture so eval-time loading reconstructs it
    cfg.extra["bert_config"] = dataclasses.asdict(bert_config)
    compute_dtype = torch.bfloat16 if args.bf16_compute else torch.float32
    if args.bit_reproducible:
        # plain PyTorch numerics at every site (the dropout masks are the
        # same Philox words on either backend)
        if (args.attention_impl in ("fused", "flash")
                or args.hidden_dropout_impl == "fused"):
            raise SystemExit("--bit-reproducible conflicts with "
                             "--attention-impl fused/flash and "
                             "--hidden-dropout-impl fused")
        args.attention_impl = args.attention_impl or "naive"
        args.hidden_dropout_impl = args.hidden_dropout_impl or "naive"
        args.ffn_impl = args.ffn_impl or "naive"
    if args.attention_impl == "flash":
        # the JAX package's library backend; the port's kernels take its place
        logging.info("--attention-impl flash has no counterpart here: 'auto'")
        args.attention_impl = "auto"
    if args.attention_impl:
        cfg.model = dataclasses.replace(cfg.model,
                                        attention_impl=args.attention_impl)
    if args.hidden_dropout_impl:
        cfg.model = dataclasses.replace(
            cfg.model, hidden_dropout_impl=args.hidden_dropout_impl)
    if args.ffn_impl:
        cfg.model = dataclasses.replace(cfg.model, ffn_impl=args.ffn_impl)
    # Flax's initial weights from a CPU generator seeded with --seed (a
    # checkpoint's weights overwrite the encoder's below)
    model = build_model(cfg.model, bert_config, dtype=compute_dtype,
                        device=device, seed=args.seed)
    if ckpt is not None:
        for bert in _bert_modules(model):
            bert.load_state_dict(ckpt.bert_state_dict())
    trainer = Trainer(model, cfg, args.out, fused_accum=args.fused_accum,
                      mesh=mesh)
    state = trainer.init_state()
    micro = cfg.train.batch_size
    n_micro = max(1, (cfg.train.accumulated_batch_size or micro) // micro)
    align = None
    if cfg.model.model_name == "sbalisentbienc":
        align = cfg.extra.get("align_type", "cc_align")
    seq_buckets = (tuple(int(x) for x in args.seq_buckets.split(","))
                   if args.seq_buckets else None)
    stream = TripleStream(args.train, tokenizer, cfg.model, micro_batch=micro,
                          n_micro=n_micro, seq_len=args.seq_len, align_type=align,
                          max_examples=cfg.train.train_size or None,
                          shuffle_seed=args.shuffle_seed,
                          seq_buckets=seq_buckets)
    devfn = None
    if args.dev:
        devfn = lambda: dev_batches(args.dev, tokenizer, cfg.model, batch_size=micro,
                                    seq_len=args.seq_len, align_type=align,
                                    max_examples=cfg.train.dev_size or None)
    # one train call owns the epoch loop: TripleStream re-iterates with a
    # per-epoch shuffle, and best-dev tracking stays global across epochs
    state = trainer.train(state, stream, devfn, seed=args.seed,
                          epochs=cfg.train.num_epochs)
    if mesh is not None:
        if trainer.is_writer:
            print(f"trained {state.step} steps on {mesh.world_size} data "
                  f"ranks ({mesh.backend}) -> {args.out}")
        return None
    print(f"trained {state.step} steps -> {args.out}")
    return trainer


def _load_eval_model(args):
    from .evaluation.models import get_model
    tokenizer = _tokenizer(args.tokenizer) if args.tokenizer else None
    return get_model(args.model, trained_model_path=args.run_dir,
                     weights_dir=args.weights_dir, tokenizer=tokenizer,
                     batch_size=getattr(args, "batch_size", 8),
                     ot_solver=getattr(args, "ot_solver", "xla"),
                     device=_device(args))


def cmd_evaluate(args):
    from .evaluation.datasets import EvalDataset
    from .evaluation.evaluate import run_evaluation

    dataset = EvalDataset(args.dataset, args.dataset_dir)
    model = _load_eval_model(args)
    facets = None
    if args.facet:
        facets = [None] if args.facet == "unfaceted" else [args.facet]
    out = run_evaluation(model, dataset, args.results,
                         actions=tuple(args.actions.split(",")),
                         facets=facets, cache_path=args.cache)
    print(json.dumps(out, indent=1, default=str))
    return out


def _read_corpus(path):
    """corpus jsonl -> (batch dicts for SimilarityModel.encode, pids)."""
    from .data.readers import read_jsonl
    corpus, pids = [], []
    for rec in read_jsonl(path):
        pids.append(rec["paper_id"])
        corpus.append({"TITLE": rec["title"], "ABSTRACT": rec["abstract"]})
    return corpus, pids


def _unit_rows(x):
    """Row-normalize [n, d] reps; build-time (sent index storage) and
    rank-time (queries) MUST share this so the cosine==L2 ordering
    equivalence holds."""
    import numpy as np
    x = np.asarray(x, np.float32)
    return x / np.clip(np.linalg.norm(x, axis=1, keepdims=True), 1e-9, None)


def _encode_all(encode, corpus, batch_size):
    import time
    out = []
    t0 = time.time()
    for i in range(0, len(corpus), batch_size):
        out.extend(encode(corpus[i:i + batch_size]))
        if i and (i // batch_size) % 20 == 0:
            done = i + batch_size
            logging.info("encoded %d/%d docs (%.1f docs/s)", done,
                         len(corpus), done / (time.time() - t0))
    return out


def cmd_build_index(args):
    import torch

    from .evaluation.models import AspireSimilarityModel
    from .index.dense import build_dense_index, build_dense_index_prequantized

    if args.n_shards < 1:
        raise SystemExit("--n-shards counts shard ranks: at least 1")
    device = _device(args)
    if args.family == "cls":
        _build_cls_index_cmd(args)
        return
    if args.family == "sent":
        _build_sent_index_cmd(args)
        return

    mkw = {"device": device}
    if args.bf16_compute:
        mkw["compute_dtype"] = torch.bfloat16
    if args.seq_buckets:
        mkw["seq_buckets"] = tuple(
            int(x) for x in args.seq_buckets.split(","))
    model = AspireSimilarityModel.from_trained(
        "index-encoder", args.run_dir, _tokenizer(args.tokenizer), **mkw) \
        if args.run_dir else AspireSimilarityModel.from_hf_dir(
            "index-encoder", args.weights_dir, **mkw)
    corpus, pids = _read_corpus(args.corpus)
    if args.seq_buckets:
        # sort by approximate token count so batches are length-homogeneous
        # and ride the smallest bucket; index results don't depend on doc
        # order (pids travel with their reps)
        order = sorted(range(len(corpus)), key=lambda i: sum(
            len(s.split()) for s in corpus[i]["ABSTRACT"])
            + len(corpus[i]["TITLE"].split()))
        corpus = [corpus[i] for i in order]
        pids = [pids[i] for i in order]
    # int8 indexing quantizes on the device inside the encode (1-byte
    # downloads) and the host only packs buckets
    encode = model.encode_quantized if args.int8 else model.encode
    reps = _encode_all(encode, corpus, args.batch_size)
    if args.int8:
        idx = build_dense_index_prequantized(reps, pids,
                                             n_shards=args.n_shards)
    else:
        idx = build_dense_index(reps, pids, n_shards=args.n_shards,
                                dtype="bfloat16" if args.bf16 else "float32")
    idx.save(args.out)
    print(f"indexed {idx.n_docs} docs ({len(idx.buckets)} buckets, "
          f"{args.n_shards} shards) -> {args.out}")


def _build_cls_index_cmd(args):
    """build-index --family cls: whole-abstract bi-encoder corpus index.

    One CLS vector per doc (reference buildreps 'cospecter' path,
    pre_proc_buildreps.py:309-439); served by `rank` via ClsIndex."""
    import numpy as np

    from .evaluation.models import ClsSimilarityModel, get_model
    from .index.cls import build_cls_index

    if args.int8 or args.seq_buckets or args.bf16_compute:
        raise ValueError("--int8/--seq-buckets/--bf16-compute are "
                         "multi-vector options; the CLS family supports "
                         "--bf16 storage only")
    if args.model:
        # the eval-model name, so that the corpus encoder matches what
        # `rank --model ...` encodes queries with
        model = _load_eval_model(args)
    elif args.run_dir:
        model = get_model("cospecter", trained_model_path=args.run_dir,
                          tokenizer=_tokenizer(args.tokenizer),
                          batch_size=args.batch_size, device=_device(args))
    else:
        model = ClsSimilarityModel.from_hf_dir("index-encoder",
                                               args.weights_dir,
                                               batch_size=args.batch_size,
                                               device=_device(args))
    corpus, pids = _read_corpus(args.corpus)
    reps = _encode_all(model.encode, corpus, args.batch_size)
    idx = build_cls_index(np.stack(reps), pids,
                          dtype="bfloat16" if args.bf16 else "float32")
    idx.save(args.out)
    print(f"indexed {idx.n_docs} docs (cls) -> {args.out}")


def _build_sent_index_cmd(args):
    """build-index --family sent: per-sentence reps from the sent-bert
    family (cosentbert/ictsentbert/sbert baselines), cosine max-sim ranking.

    Mirrors the reference's build_sentbert_reps
    (pre_proc_buildreps.py:309-370) + cosine ranking
    (pp_gen_nearest.py:793-794).  Reps are stored L2-NORMALIZED so the
    standard l2max dense-bucket search ranks identically to cosine max-sim
    (for unit vectors L2^2 = 2 - 2cos); `rank` converts scores back."""
    from .index.dense import build_dense_index

    if args.int8 or args.bf16_compute or args.seq_buckets:
        raise ValueError("--int8/--bf16-compute/--seq-buckets are "
                         "aspire-family options; the sent family supports "
                         "--bf16 storage only")
    if not args.model:
        raise ValueError("--family sent needs --model (cosentbert/"
                         "ictsentbert with --run-dir, or an sbert baseline "
                         "with --weights-dir)")
    model = _load_eval_model(args)
    corpus, pids = _read_corpus(args.corpus)
    reps = [_unit_rows(r)
            for r in _encode_all(model.encode, corpus, args.batch_size)]
    idx = build_dense_index(reps, pids, n_shards=args.n_shards,
                            dtype="bfloat16" if args.bf16 else "float32",
                            score_type="cosine")
    idx.save(args.out)
    print(f"indexed {idx.n_docs} docs (sent/cosine, {len(idx.buckets)} "
          f"buckets, {args.n_shards} shards) -> {args.out}")


def _resolve_ot_params(args, model=None) -> tuple[float, float, float]:
    """(temp, blur, scaling) for OT scoring/reranking.

    Explicit flags win (warning on mismatch with the trained run); otherwise
    the model's own hyperparameters (the loaded eval model carries them, as
    the reference re-reads run_info, pp_gen_nearest.py:96-98), falling back
    to the run_dir's run_info.json, then to the reference otstuni defaults
    (5000/0.05/0.9) only when no trained source exists."""
    defaults = {"temp": 5000.0, "blur": 0.05, "scaling": 0.9}
    trained = {}
    if model is not None and hasattr(model, "ot_temp"):
        trained = {"temp": model.ot_temp, "blur": model.blur,
                   "scaling": model.scaling}
    elif args.run_dir:
        info_path = os.path.join(args.run_dir, "run_info.json")
        if os.path.exists(info_path):
            from .core.config import RunConfig
            rc = RunConfig.from_run_info(info_path)
            trained = {"temp": rc.model.sent_sm_temp,
                       "blur": rc.model.geoml_blur,
                       "scaling": rc.model.geoml_scaling}
    out = {}
    for key, flag in (("temp", args.ot_temp), ("blur", args.ot_blur),
                      ("scaling", args.ot_scaling)):
        if flag is not None:
            if trained and abs(flag - trained[key]) > 1e-9:
                logging.warning(
                    "--ot-%s=%g overrides the trained model's %g "
                    "(run_info.json); reranking will not match the "
                    "model's training-time scoring", key, flag, trained[key])
            out[key] = float(flag)
        else:
            out[key] = float(trained.get(key, defaults[key]))
    return out["temp"], out["blur"], out["scaling"]


def _pool_id_matrix(pool: dict, pid2row: dict, qpids: list, align: int = 8):
    """qpid -> cand pid lists to a padded i32[B, P] index-row matrix.

    P = largest pool size rounded up to `align` (-1 pads).  Every pool
    candidate MUST be in the index -- the pool protocol scores the FULL
    pool (pp_gen_nearest.py:241-283); a missing candidate is a corpus/pool
    mismatch, reported by name instead of silently dropped."""
    import numpy as np
    sizes = [len(pool[q]["cands"]) for q in qpids]
    pmax = max(align, -(-max(sizes) // align) * align)
    ids = np.full((len(qpids), pmax), -1, np.int32)
    for i, q in enumerate(qpids):
        for j, c in enumerate(pool[q]["cands"]):
            row = pid2row.get(c, pid2row.get(str(c)))
            if row is None:
                raise ValueError(
                    f"pool candidate {c!r} (query {q!r}) is not in the "
                    "index: the pool protocol ranks the FULL candidate pool "
                    "(pp_gen_nearest.py:241-283) -- rebuild the index over "
                    "a corpus containing every pool candidate, or use "
                    "--protocol global for corpus-wide retrieval")
            ids[i, j] = row
    return ids


def _query_rows(args, dataset, model, qpids, q_encs, cosine: bool):
    """Per-query [n, d] f32 reps: facet-filtered, unit rows for a cosine
    index (matching its unit-normalized storage)."""
    import numpy as np
    out = []
    for qpid in qpids:
        q = q_encs[qpid]
        if args.facet:
            # faceted search: only the query sentences labelled with the
            # facet participate (rank_pool_sentfaceted, pp_gen_nearest.py:988)
            q = model.get_faceted_encoding(q, args.facet, dataset.get(qpid))
        q = np.asarray(q, np.float32)
        out.append(_unit_rows(q) if cosine else q)
    return out


def _pack_queries(q_list, dim: int, bsz: int):
    """[bsz, qmax, d] zero-padded queries (qmax: the longest rounded up to 8)
    and their lengths; rows past len(q_list) are one zero sentence."""
    import numpy as np
    qmax = max(8, -(-max(len(q) for q in q_list) // 8) * 8)
    q_arr = np.zeros((bsz, qmax, dim), np.float32)
    q_lens = np.ones((bsz,), np.int32)
    for i, q in enumerate(q_list):
        q_arr[i, : len(q)] = q
        q_lens[i] = len(q)
    return q_arr, q_lens


def _refuse_cls_options(args) -> None:
    if args.facet:
        raise ValueError("a CLS index holds one whole-abstract vector "
                         "per doc; faceted ranking needs a multi-vector "
                         "index")
    if args.rerank == "ot":
        raise ValueError("OT rerank needs sentence reps; a CLS index "
                         "ranks by whole-abstract L2 only")


def _rank_pools(args, dataset, model, device, solver: str,
                index_type: str, mesh=None) -> None:
    """POOL protocol: score each query against exactly its candidate pool.

    This is the reference's primary ranking protocol
    (caching_scoringmodel_rank_pool_sent, pp_gen_nearest.py:241-283): the
    full pool is ranked -- never global top-k -- so `rank ->
    eval_pool_ranking` reproduces the paper's evaluation.  Candidate reps are
    gathered on the device from the index and scored with the model's own
    aggregation (OT with the trained hyperparameters / l2max / jointsm /
    cosine max-sim / CLS -L2) in one call over all queries (on a serving
    mesh: each rank the pool members it holds, merged by one all_reduce).
    """
    import numpy as np
    import torch

    from .index.dense import DenseBucketIndex, flatten_device_buckets

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    pool = dataset.get_test_pool(facet=args.facet)
    qpids = list(pool)
    q_encs = model.get_encoding(qpids, dataset)

    if index_type == "cls":
        _refuse_cls_options(args)
        from .index.cls import ClsIndex
        from .index.serve import make_cls_pool_rank_batched
        idx = ClsIndex.load(args.index)
        pid2row = {p: i for i, p in enumerate(idx.pids)}
        cand_ids = _pool_id_matrix(pool, pid2row, qpids)
        q_arr = np.stack([np.asarray(q_encs[q], np.float32).reshape(-1)
                          for q in qpids])
        reps, norms = idx.device_arrays(device, mesh)
        sims = make_cls_pool_rank_batched(mesh)(dev(q_arr), dev(cand_ids),
                                                reps, norms).cpu().numpy()
    else:
        idx = DenseBucketIndex.load(args.index)
        if idx.score_type == "cosine":
            # reference parity: the sent-bert family ranks by cosine max-sim
            # only (pp_gen_nearest.py:793-794); OT is an aspire multi-vector
            # scorer with an L2 ground cost
            if args.rerank == "ot":
                raise ValueError("OT rerank applies to aspire (l2) indexes; "
                                 "a --family sent index ranks by cosine "
                                 "max-sim")
            agg = "cosine_max"
        else:
            # the model's own aggregation scores the pool; an explicit
            # --rerank ot forces OT scoring of the multi-vector reps
            agg = "ot" if args.rerank == "ot" else getattr(model, "agg",
                                                           "l2max")
        logging.info("pool protocol: scoring %d query pools with agg=%s",
                     len(qpids), agg)
        pid2row = {p: i for i, p in enumerate(idx.pids)}
        cand_ids = _pool_id_matrix(pool, pid2row, qpids)
        q_list = _query_rows(args, dataset, model, qpids, q_encs,
                             idx.score_type == "cosine")
        q_arr, q_lens = _pack_queries(q_list, idx.dim, len(q_list))
        ot_temp, ot_blur, ot_scaling = _resolve_ot_params(args, model)
        from .index.serve import make_pool_rank_batched
        buckets = idx.device_arrays(device, mesh)
        fn = make_pool_rank_batched(
            len(buckets), pool_size=cand_ids.shape[1],
            max_sents=args.max_sents, agg=agg, int8=idx.is_int8,
            blur=ot_blur, scaling=ot_scaling, temp=ot_temp,
            solver=solver, score_type=idx.score_type, mesh=mesh)
        sims = fn(dev(q_arr), dev(q_lens), dev(cand_ids),
                  *flatten_device_buckets(buckets),
                  *idx.device_pos_arrays(device, mesh)).cpu().numpy()
    ranked = {}
    for i, qpid in enumerate(qpids):
        cands = pool[qpid]["cands"]
        s = sims[i, : len(cands)]
        order = np.argsort(-s, kind="stable")   # stable: ties keep pool order
        ranked[qpid] = [[cands[j], float(s[j])] for j in order]
    _write_rank_outputs(args, dataset, ranked, mesh)


def cmd_rank(args):
    """Rank query pools against an index: the serving CLI.

    Default --protocol pool scores each query against exactly its candidate
    pool (the reference's primary protocol; see _rank_pools).  --protocol
    global instead retrieves top-k over the WHOLE corpus: queries batch
    through one make_dense_search_batched call (intermediate bounded by
    --q-chunk), then an optional OT rerank.  Mirrors
    pp_gen_nearest.py:207-363 ranking + :575-635 readable neighbour dumps +
    :125-129 rep caching.

    --n-shards N: N serving ranks (times --num-processes machines), each
    holding 1/N of the index; every rank encodes the queries, the searches
    merge over the ranks, rank 0 writes.
    """
    from .parallel.mesh import make_serving_mesh
    return _on_ranks(args, _rank, args.n_shards, make_serving_mesh)


def _rank(args, mesh):
    import numpy as np
    import torch

    from .evaluation.datasets import EvalDataset
    from .evaluation.models import resolve_ot_solver
    from .index.dense import (DenseBucketIndex, flatten_device_buckets,
                              make_dense_search_batched)

    device = _device(args)
    # 'auto': K1 on a CUDA device, the plain loop on the CPU
    solver = resolve_ot_solver(args.ot_solver, device)
    with open(os.path.join(args.index, "meta.json")) as f:
        index_type = json.load(f).get("index_type", "multivec")
    dataset = EvalDataset(args.dataset, args.dataset_dir)
    model = _load_eval_model(args)
    if args.cache and (mesh is None or mesh.rank == 0):
        # one writer: h5 has no several-writer mode; the other ranks encode
        model.set_encodings_cache(args.cache)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if args.protocol == "pool":
        _rank_pools(args, dataset, model, device, solver, index_type, mesh)
        return

    if index_type == "cls":
        # whole-abstract bi-encoder corpus (reference CLS ranking,
        # pp_gen_nearest.py:638-726): one vector per doc, no facets and
        # nothing to rerank
        _refuse_cls_options(args)
        from .index.cls import ClsIndex, make_cls_search_batched
        idx = ClsIndex.load(args.index)
        pool = dataset.get_test_pool()
        qpids = list(pool)
        q_encs = model.get_encoding(qpids, dataset)
        q_arr = np.stack([np.asarray(q_encs[q], np.float32).reshape(-1)
                          for q in qpids])
        reps, norms = idx.device_arrays(device, mesh)
        q_chunk = max(1, min(args.q_chunk, len(q_arr)))
        search = make_cls_search_batched(k=args.k, q_chunk=q_chunk, mesh=mesh)
        scores, docs = search(dev(q_arr), reps, norms)
        scores, docs = scores.cpu().numpy(), docs.cpu().numpy()
        ranked = {}
        for i, qpid in enumerate(qpids):
            real = docs[i] >= 0
            ranked[qpid] = [[idx.pids[d], float(s)]
                            for d, s in zip(docs[i][real], scores[i][real])]
        _write_rank_outputs(args, dataset, ranked, mesh)
        return

    idx = DenseBucketIndex.load(args.index)
    if idx.score_type == "cosine" and args.rerank == "ot":
        raise ValueError("OT rerank applies to aspire (l2) indexes; a "
                         "--family sent index ranks by cosine max-sim")
    buckets = idx.device_arrays(device, mesh)
    flat = flatten_device_buckets(buckets)
    pool = dataset.get_test_pool(facet=args.facet)
    qpids = list(pool)
    # encode every pool query (one cached bulk pass), then facet-filter
    q_encs = model.get_encoding(qpids, dataset)
    q_list = _query_rows(args, dataset, model, qpids, q_encs,
                         idx.score_type == "cosine")
    q_chunk = max(1, min(args.q_chunk, len(q_list)))
    bsz = -(-len(q_list) // q_chunk) * q_chunk   # pad queries to chunk multiple
    q_arr, q_lens = _pack_queries(q_list, idx.dim, bsz)
    ranked = {}
    if args.rerank == "ot":
        # fused: search + device candidate gather + Sinkhorn rerank with no
        # host round trip between the stages (index.serve)
        from .index.serve import make_fused_query_batched
        ot_temp, ot_blur, ot_scaling = _resolve_ot_params(args, model)
        fused = make_fused_query_batched(
            len(buckets), k=args.k, max_sents=args.max_sents,
            int8=idx.is_int8, q_chunk=q_chunk, temp=ot_temp, blur=ot_blur,
            scaling=ot_scaling, solver=solver, mesh=mesh)
        _, docs, sims = fused(dev(q_arr), dev(q_lens), *flat,
                              *idx.device_pos_arrays(device, mesh))
        docs, sims = docs.cpu().numpy(), sims.cpu().numpy()
        for i, qpid in enumerate(qpids):
            real = docs[i] >= 0
            docs_i, sims_i = docs[i][real], sims[i][real]
            order = np.argsort(-sims_i)
            ranked[qpid] = [[idx.pids[docs_i[j]], float(sims_i[j])]
                            for j in order]
    else:
        # --rerank none: the scan is the final ranking for every score_type
        search = make_dense_search_batched(len(buckets), k=args.k,
                                           int8=idx.is_int8, q_chunk=q_chunk,
                                           exact=True, mesh=mesh)
        scores, docs = search(dev(q_arr), dev(q_lens), *flat)
        scores, docs = scores.cpu().numpy(), docs.cpu().numpy()
        for i, qpid in enumerate(qpids):
            real = docs[i] >= 0     # mask ids AND scores together
            docs_i = docs[i][real]
            scores_i = scores[i][real]
            if idx.score_type == "cosine":
                # search scores are -L2 of unit vectors; report the
                # reference's cosine values (pp_gen_nearest.py:793-794)
                scores_i = 1.0 - scores_i * scores_i / 2.0
            ranked[qpid] = [[idx.pids[d], float(s)]
                            for d, s in zip(docs_i, scores_i)]
    _write_rank_outputs(args, dataset, ranked, mesh)


def _write_rank_outputs(args, dataset, ranked: dict, mesh=None) -> None:
    """Ranked-pool json + readable neighbour dumps (pp_gen_nearest.py:575-635),
    written by rank 0 alone on a serving mesh (every rank holds the same
    `ranked`)."""
    from .evaluation.ranking_eval import print_pool_neighbours
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(args.out, exist_ok=True)
    suffix = f"-{args.facet}" if args.facet else ""
    fname = os.path.join(
        args.out, f"test-pid2pool-{args.dataset}-{args.model}{suffix}-ranked.json")
    with open(fname, "w") as f:
        json.dump(ranked, f)
    if not args.no_dumps:
        print_pool_neighbours(dataset, ranked,
                              os.path.join(args.out, f"neighbours{suffix}"),
                              top_k=args.dump_k)
    print(f"ranked {len(ranked)} queries -> {fname}")


def _read_query_evaluations(path: str) -> dict:
    """query-evaluations*.csv -> {paper_id: {column: value}}, numbers as
    floats (what pandas' read_csv gives the JAX CLI's compare)."""
    import csv

    def num(v):
        try:
            return float(v)
        except ValueError:
            return v

    with open(path, newline="", encoding="utf-8") as f:
        return {row["paper_id"]: {k: (v if k == "paper_id" else num(v))
                                  for k, v in row.items()}
                for row in csv.DictReader(f)}


def cmd_compare(args):
    """Welch t-test between two methods' per-query metrics
    (ranking_eval.py:611-713 significance protocol)."""
    import numpy as np

    from .evaluation.protocols import significance_test

    qa = _read_query_evaluations(args.results_a)
    qb = _read_query_evaluations(args.results_b)
    t, p, sig = significance_test(qa, qb, metric=args.metric,
                                  n_comparisons=args.n_comparisons)
    out = {"metric": args.metric, "t": round(t, 4), "p": round(p, 6),
           "significant_bonferroni_0.05": sig,
           "mean_a": round(float(np.mean([v[args.metric] for v in qa.values()])), 4),
           "mean_b": round(float(np.mean([v[args.metric] for v in qb.values()])), 4)}
    print(json.dumps(out))
    return out


def cmd_preprocess(args):
    from .data import preprocess as pp
    return pp.main(args)


def cmd_ner(args):
    from .data import ner
    if args.extractor == "scispacy":
        extractor = ner.scispacy_entity_extractor(args.spacy_model)
    else:
        extractor = ner.simple_entity_extractor
    n = ner.write_ner_file(args.abstracts, args.out, extractor)
    logging.info("wrote NER entities for %d papers -> %s", n, args.out)


def _device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device; without CUDA the run raises "
                             "unless 'cpu' is given")


def build_parser():
    p = argparse.ArgumentParser(prog="aspire_tpu_torch")
    sub = p.add_subparsers(dest="subcommand", required=True)

    t = sub.add_parser("train", help="train a doc-similarity model")
    t.add_argument("--config", required=True)
    t.add_argument("--train", required=True)
    t.add_argument("--dev")
    t.add_argument("--out", required=True)
    t.add_argument("--tokenizer", help="local dir with vocab.txt (default: "
                                       "the config's base-pt-layer)")
    t.add_argument("--init-hf-dir", help="local HF dir for encoder init")
    t.add_argument("--seq-len", type=int, default=512)
    t.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel ranks on this machine, one a card "
                        "(nccl; gloo ranks with --device cpu)")
    t.add_argument("--coordinator", default=None,
                   help="several machines: rank 0's host:port; run the same "
                        "command on every machine with its own --process-id")
    t.add_argument("--num-processes", type=int, default=None,
                   help="several machines: how many")
    t.add_argument("--process-id", type=int, default=None,
                   help="several machines: this one's index (0-based)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--tiny", action="store_true", help="tiny BERT (smoke test)")
    t.add_argument("--bf16-compute", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="bf16 activations (parameters and optimizer stay "
                        "f32); --no-bf16-compute for f32 activations")
    t.add_argument("--fused-accum", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="one wide encode of the whole accumulation window "
                        "(the same summed gradients); --no-fused-accum runs "
                        "the micro batches one after another")
    t.add_argument("--fast-tokenizer", action="store_true",
                   help="accepted; the native tokenizer is the only one")
    t.add_argument("--fast-rng", action="store_true",
                   help="JAX package only (the TPU bit generator): refused")
    t.add_argument("--attention-impl", default=None,
                   choices=["auto", "naive", "flash", "fused"],
                   help="BERT attention backend: 'auto' runs the CUDA "
                        "kernels on a CUDA device; 'flash' is read as 'auto'")
    t.add_argument("--hidden-dropout-impl", default=None,
                   choices=["auto", "naive", "fused"],
                   help="hidden/embedding dropout backend ('auto': the CUDA "
                        "kernel on a CUDA device)")
    t.add_argument("--ffn-impl", default=None,
                   choices=["auto", "naive", "fused"],
                   help="FFN backend ('auto': no-grad passes through the "
                        "fused CUDA kernel, grad passes through the split "
                        "FFN)")
    t.add_argument("--bit-reproducible", action="store_true",
                   help="plain PyTorch attention, FFN and dropout at every "
                        "site (the same Philox masks)")
    t.add_argument("--seq-buckets",
                   help="comma-separated length buckets, e.g. 192,320,512")
    t.add_argument("--shuffle-seed", type=int, default=None,
                   help="per-epoch seeded shuffle of the training stream")
    t.add_argument("--log_fname")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="encode/score/evaluate a dataset")
    e.add_argument("--dataset", required=True)
    e.add_argument("--dataset-dir", required=True)
    e.add_argument("--model", required=True)
    e.add_argument("--results", required=True)
    e.add_argument("--actions", default="encode,score,evaluate")
    e.add_argument("--facet", help="background|method|result|unfaceted")
    e.add_argument("--cache", help="h5 encodings cache (needs h5py)")
    e.add_argument("--batch-size", type=int, default=8,
                   help="encode batch size (reference used 8)")
    e.add_argument("--ot-solver", choices=["xla", "pallas"], default="xla",
                   help="OT scoring solver: xla (the plain PyTorch loop, "
                        "reference parity) or pallas (the CUDA kernel K1)")
    e.add_argument("--run-dir")
    e.add_argument("--weights-dir")
    e.add_argument("--tokenizer")
    e.add_argument("--log_fname")
    _device_flag(e)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("build-index", help="encode a corpus into an index")
    b.add_argument("--corpus", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--run-dir")
    b.add_argument("--weights-dir")
    b.add_argument("--tokenizer")
    b.add_argument("--family", choices=["multivec", "cls", "sent"],
                   default="multivec",
                   help="multivec: aspire sentence reps (l2/OT scoring); "
                        "cls: one whole-abstract vector per doc (specter/"
                        "cospecter bi-encoders); sent: per-sentence reps "
                        "from the sent-bert family, cosine max-sim")
    b.add_argument("--model",
                   help="(--family sent) eval-model name, e.g. cosentbert/"
                        "ictsentbert (--run-dir) or sbtinybertsota "
                        "(--weights-dir)")
    b.add_argument("--n-shards", type=int, default=1,
                   help="pack the index for this many shard ranks")
    b.add_argument("--batch-size", type=int, default=32)
    b.add_argument("--bf16", action="store_true")
    b.add_argument("--int8", action="store_true",
                   help="per-sentence-scale int8 storage (half the scan bytes)")
    b.add_argument("--bf16-compute", action="store_true",
                   help="encode with bf16 activations (reps stay f32)")
    b.add_argument("--seq-buckets",
                   help="comma list, e.g. 128,256,384,512: sort the corpus "
                        "by length and encode each batch at the smallest "
                        "bucket covering it")
    b.add_argument("--log_fname")
    _device_flag(b)
    b.set_defaults(fn=cmd_build_index)

    r = sub.add_parser("rank", help="rank query pools against an index")
    r.add_argument("--index", required=True)
    r.add_argument("--dataset", required=True)
    r.add_argument("--dataset-dir", required=True)
    r.add_argument("--model", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--facet")
    r.add_argument("--protocol", choices=["pool", "global"], default="pool",
                   help="pool (default): rank each query's FULL candidate "
                        "pool from test-pid2anns -- the reference's "
                        "evaluation protocol (pp_gen_nearest.py:241-283); "
                        "global: corpus-wide top-k retrieval + optional OT "
                        "rerank")
    r.add_argument("--k", type=int, default=100,
                   help="top-k for --protocol global (pool mode ranks the "
                        "whole pool)")
    r.add_argument("--rerank", choices=["none", "ot"], default="none")
    r.add_argument("--ot-temp", type=float, default=None,
                   help="marginal softmax temp; default: the trained run's "
                        "sent_sm_temp (run_info.json), else 5000")
    r.add_argument("--ot-blur", type=float, default=None,
                   help="Sinkhorn blur; default: trained geoml_blur, else .05")
    r.add_argument("--ot-scaling", type=float, default=None,
                   help="eps-annealing rate; default: trained geoml_scaling, "
                        "else .9")
    r.add_argument("--ot-solver", choices=["auto", "pallas", "xla"],
                   default="auto",
                   help="rerank solver: auto (the CUDA kernel K1 on a CUDA "
                        "device, the plain loop on the CPU), or force one; "
                        "xla gives reference-parity scores")
    r.add_argument("--max-sents", type=int, default=24)
    r.add_argument("--cache", help="h5 query-encoding cache (reference "
                                   "joblib rep cache, pp_gen_nearest.py:125)")
    r.add_argument("--n-shards", type=int, default=1,
                   help="index-shard ranks on this machine, one a card "
                        "(nccl; gloo ranks with --device cpu)")
    r.add_argument("--coordinator", default=None,
                   help="several machines: rank 0's host:port; run the same "
                        "command on every machine with its own --process-id")
    r.add_argument("--num-processes", type=int, default=None,
                   help="several machines: how many")
    r.add_argument("--process-id", type=int, default=None,
                   help="several machines: this one's index (0-based)")
    r.add_argument("--q-chunk", type=int, default=8,
                   help="query-batch chunk bounding the scan intermediate")
    r.add_argument("--no-dumps", action="store_true",
                   help="skip the readable per-query neighbour dumps")
    r.add_argument("--dump-k", type=int, default=10,
                   help="neighbours per query in the readable dumps")
    r.add_argument("--run-dir")
    r.add_argument("--weights-dir")
    r.add_argument("--tokenizer")
    r.add_argument("--log_fname")
    _device_flag(r)
    r.set_defaults(fn=cmd_rank)

    c = sub.add_parser("compare", help="significance test between two runs")
    c.add_argument("--results-a", required=True,
                   help="query-evaluations.csv of method A")
    c.add_argument("--results-b", required=True)
    c.add_argument("--metric", default="av_precision")
    c.add_argument("--n-comparisons", type=int, default=1)
    c.add_argument("--log_fname")
    c.set_defaults(fn=cmd_compare)

    pp = sub.add_parser("preprocess", help="dataset preparation pipelines")
    pp.add_argument("action", choices=["gorc", "cocit-examples",
                                       "regen-examples", "relish",
                                       "treccovid", "scidocs", "filter-cocits"])
    pp.add_argument("--in-path", required=True)
    pp.add_argument("--out-path", required=True)
    pp.add_argument("--extra", help="json dict of pipeline-specific options")
    pp.add_argument("--log_fname")
    _device_flag(pp)
    pp.set_defaults(fn=cmd_preprocess)

    n = sub.add_parser("ner", help="extract entities into {dataset}-ner.jsonl")
    n.add_argument("--abstracts", required=True,
                   help="abstracts-{dataset}.jsonl input")
    n.add_argument("--out", required=True)
    n.add_argument("--extractor", choices=["simple", "scispacy"],
                   default="simple")
    n.add_argument("--spacy-model", default="en_core_sci_sm")
    n.add_argument("--log_fname")
    _device_flag(n)
    n.set_defaults(fn=cmd_ner)
    return p


def main(argv=None):
    """Parse `argv` and run the subcommand; returns what it returns (the
    evaluation's aggregates, the trainer, the comparison)."""
    args = build_parser().parse_args(argv)
    _setup_logging(args)
    return args.fn(args)
