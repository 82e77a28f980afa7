"""The port's spans (utils/profiling.py) on the CPU at tiny sizes: off, a span
is the shared no-op and leaves nothing; on (under `recording()` or a
profiler), the fused query, the pool ranking and the encoders record their
stages in order under one call id, with the counts their shapes give; the
labels are host events; summary's self times; a raising body; the buffer's
bound; answers equal with tracing on and off; the exporter's file."""
import collections
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.index import serve as tserve
from aspire_tpu_torch.models.bert import BertConfig
from aspire_tpu_torch.models.encoders import BiEncoder, ConSentEncoder
from aspire_tpu_torch.utils import profiling

DIM, MS, K = 16, 10, 5
CPU = ProfilerActivity.CPU


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _index(rng, dtype="int8", n_docs=40, buckets=(4, 8, 12)):
    reps = [rng.normal(size=(int(rng.integers(1, 12)), DIM)).astype(np.float32)
            for _ in range(n_docs)]
    idx = tdense.build_dense_index(reps, [f"p{i}" for i in range(n_docs)],
                                   dtype=dtype, buckets=buckets)
    buckets = idx.device_arrays("cpu")
    return idx, buckets, (*tdense.flatten_device_buckets(buckets),
                          *idx.device_pos_arrays("cpu"))


def _queries(rng, bsz, qmax=6):
    q = rng.normal(size=(bsz, qmax, DIM)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, bsz)
    for i in range(bsz):
        q[i, q_lens[i]:] = 0
    return torch.from_numpy(q), torch.from_numpy(q_lens)


def _fused(rng, bsz=3, dtype="int8"):
    idx, _, args = _index(rng, dtype)
    q, q_lens = _queries(rng, bsz)
    fn = tserve.make_fused_query_batched(len(idx.buckets), K, MS,
                                         int8=dtype == "int8", temp=5.0)
    return lambda: fn(q, q_lens, *args)


def _pool(rng, bsz=2, pool=6):
    idx, _, args = _index(rng, "bfloat16")
    q, q_lens = _queries(rng, bsz)
    cand = torch.from_numpy(rng.integers(-1, idx.n_docs, (bsz, pool)).astype(np.int32))
    fn = tserve.make_pool_rank_batched(len(idx.buckets), pool, MS, agg="ot", temp=5.0,
                                       rerank_chunk=1)
    return lambda: fn(q, q_lens, cand, *args)


def _tree(recs):
    """(name, depth) of each record in the order the spans opened."""
    by_id = {r["id"]: r for r in recs}
    depth = lambda r: 0 if r["parent"] is None else 1 + depth(by_id[r["parent"]])
    return [(r["name"], depth(r)) for r in sorted(recs, key=lambda r: r["id"])]


def test_off_is_the_shared_noop_and_touches_no_torch(rng, monkeypatch):
    call = _fused(rng)
    assert profiling.span("scan") is profiling._NOOP
    assert profiling.span("gather", bytes=1) is profiling._NOOP

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"torch.{name} called with tracing off")

    def refuse(*a, **kw):
        raise AssertionError("a span was made with tracing off")
    monkeypatch.setattr(profiling, "torch", Refuse())
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    call()
    monkeypatch.undo()
    assert profiling.records() == []


def test_off_leaves_no_label_on_a_later_profiler(rng):
    call = _fused(rng)
    call()
    x = torch.randn(8, 8)
    with torch.profiler.profile(activities=[CPU]) as prof:
        (x @ x).sum()
    assert not [e for e in prof.events() if e.name.startswith("aspire:")]
    assert profiling.records() == []


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_fused_query_records_its_stages_under_one_call(rng, dtype):
    call = _fused(rng, dtype=dtype)
    with profiling.recording():
        call()
    recs = profiling.records()
    assert _tree(recs) == [("fused_query", 0), ("scan", 1), ("gather", 1),
                           ("rerank", 1), ("diameter", 2), ("cost", 2), ("solve", 2),
                           ("scores", 1)]
    root = next(r for r in recs if r["parent"] is None)
    assert {r["call"] for r in recs} == {root["id"]}
    assert root["counts"] == {"queries": 3}
    assert next(r for r in recs if r["name"] == "rerank")["counts"] == {"pairs": 3 * K}
    assert all(r["device_ms"] is None and r["host_ms"] >= 0 for r in recs)


def test_single_query_is_the_batched_root_once(rng):
    idx, _, args = _index(rng)
    q, q_lens = _queries(rng, 1)
    fn = tserve.make_fused_query(len(idx.buckets), K, MS, int8=True, temp=5.0)
    with profiling.recording():
        fn(q[0], int(q_lens[0]), *args)
        fn(q[0], int(q_lens[0]), *args)
    roots = [r for r in profiling.records() if r["parent"] is None]
    assert [r["name"] for r in roots] == ["fused_query"] * 2
    assert [r["counts"] for r in roots] == [{"queries": 1}] * 2
    assert len({r["call"] for r in profiling.records()}) == 2


def test_pool_rank_records_a_gather_and_rerank_a_chunk(rng):
    call = _pool(rng)
    with profiling.recording():
        call()
    recs = profiling.records()
    assert _tree(recs) == [("pool_rank", 0),
                           ("gather", 1), ("rerank", 1), ("cost", 2), ("diameter", 2),
                           ("solve", 2),
                           ("gather", 1), ("rerank", 1), ("cost", 2), ("diameter", 2),
                           ("solve", 2), ("scores", 1)]
    assert sum(r["counts"]["pairs"] for r in recs if r["name"] == "rerank") == 2 * 6


@pytest.mark.parametrize("kind", ["consent", "biencoder"])
def test_encoder_records_embed_each_layer_and_the_head(kind):
    cfg = BertConfig.tiny(num_hidden_layers=3)
    torch.manual_seed(0)
    ids = torch.randint(1, 128, (2, 12))
    mask = torch.ones_like(ids)
    with torch.no_grad(), profiling.recording():
        if kind == "consent":
            ConSentEncoder(cfg, max_sents=4, device="cpu").eval()(
                ids, mask, torch.randint(-1, 4, (2, 12)))
        else:
            BiEncoder(cfg, device="cpu").eval()(ids, mask)
    head = "pool" if kind == "consent" else "cls_mix"
    recs = profiling.records()
    assert _tree(recs) == ([("encode", 0), ("bert.embed", 1)]
                           + [("bert.layer", 1)] * 3 + [(head, 1)])
    assert next(r for r in recs if r["name"] == "encode")["counts"] == {"tokens": 24}


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_gather_bytes_is_the_shape_arithmetic(rng, dtype):
    _, buckets, args = _index(rng, dtype, buckets=(4, 8, 12))
    assert [b["sents"].shape[1] for b in buckets] == [4, 8, 12]
    ids = torch.tensor([3, -1, 39, 0, 7, 7, 21], dtype=torch.int32)
    with profiling.recording():
        tserve._gather_candidates(buckets, *args[-3:], ids, max_sents=10)
    (rec,) = profiling.records()
    item = {"int8": 1, "bfloat16": 2, "float32": 4}[dtype]
    scale = 4 if dtype == "int8" else 0            # an f32 scale a sentence
    # the buckets' widths cut at max_sents: 4 + 8 + 10 sentences a candidate
    assert rec["counts"] == {"bytes": 7 * (4 + 8 + 10) * (DIM * item + scale)}


def test_profiler_labels_are_host_events_and_record_only_there(rng):
    call = _fused(rng)
    with torch.profiler.profile(activities=[CPU]) as prof:
        call()
    call()                                   # after the profiler: nothing recorded
    labels = [e for e in prof.events() if e.name.startswith("aspire:")]
    assert {e.name for e in labels} == {f"aspire:{n}" for n in (
        "fused_query", "scan", "gather", "rerank", "diameter", "cost", "solve",
        "scores")}
    assert all(e.device_type == DeviceType.CPU for e in labels)
    assert len(profiling.records()) == 8


def test_summary_self_time_is_total_less_children(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))           # 1 ms a reading
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    with profiling.recording():
        with profiling.span("outer"):              # 0 .. 7
            with profiling.span("inner"):          # 1 .. 4
                with profiling.span("leaf"):       # 2 .. 3
                    pass
            with profiling.span("inner"):          # 5 .. 6
                pass
    s = profiling.summary()
    assert s["outer"]["count"] == 1 and s["inner"]["count"] == 2
    assert s["outer"]["host_ms"] == 7.0 and s["outer"]["host_self_ms"] == 3.0
    assert s["inner"]["host_ms"] == 4.0 and s["inner"]["host_self_ms"] == 3.0
    assert s["leaf"]["host_self_ms"] == s["leaf"]["host_ms"] == 1.0
    assert s["outer"]["device_ms"] is None and s["outer"]["device_self_ms"] is None


def test_a_raising_body_closes_its_span():
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("stage failed")
        with profiling.span("next"):
            pass
    recs = {r["name"]: r for r in profiling.records()}
    assert set(recs) == {"outer", "inner", "next"}
    assert recs["inner"]["parent"] == recs["outer"]["id"]
    assert recs["next"]["parent"] is None and recs["next"]["call"] == recs["next"]["id"]
    assert profiling._local.stack == []


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    with profiling.recording():
        for i in range(20):
            with profiling.span("step", i=i):
                pass
    assert [r["counts"]["i"] for r in profiling.records()] == list(range(12, 20))


@pytest.mark.parametrize("path", ["fused", "pool"])
def test_answers_are_bitwise_equal_with_tracing_on_and_off(rng, path):
    call = _fused(rng) if path == "fused" else _pool(rng)
    off = call()
    with profiling.recording():
        on = call()
    assert profiling.records()
    for a, b in zip(off if isinstance(off, tuple) else (off,),
                    on if isinstance(on, tuple) else (on,)):
        assert torch.equal(a, b)


def test_trace_log_dir_holds_the_span_names(rng, tmp_path):
    call = _fused(rng)
    with profiling.trace(str(tmp_path / "tb")):
        call()
    (path,) = (tmp_path / "tb").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"aspire:fused_query", "aspire:scan", "aspire:gather",
            "aspire:rerank", "aspire:solve"} <= names


def _mesh_rank(seed):
    from aspire_tpu_torch.parallel import mesh as pm
    rng = np.random.default_rng(seed)
    reps = [rng.normal(size=(int(rng.integers(1, 12)), DIM)).astype(np.float32)
            for _ in range(40)]
    idx = tdense.build_dense_index(reps, [f"p{i}" for i in range(40)],
                                   n_shards=2, dtype="int8", buckets=(4, 8, 12))
    mesh = pm.make_serving_mesh(2)
    q, q_lens = _queries(rng, 3)
    fn = tserve.make_fused_query_batched(len(idx.buckets), K, MS, int8=True,
                                         temp=5.0, mesh=mesh)
    with profiling.recording():
        fn(q, q_lens, *tdense.flatten_device_buckets(idx.device_arrays("cpu", mesh)),
           *idx.device_pos_arrays("cpu", mesh))
    recs = profiling.records()
    return _tree(recs), [r["counts"] for r in recs if r["name"] == "reduce"]


def test_mesh_records_the_merge_and_the_reduces():
    from aspire_tpu_torch.parallel import mesh as pm
    for tree, reduces in pm.run_ranks(_mesh_rank, 2, 5, device="cpu"):
        assert tree == [("fused_query", 0), ("scan", 1), ("merge", 1), ("gather", 1),
                        ("rerank", 1), ("diameter", 2), ("reduce", 3),
                        ("cost", 2), ("solve", 2), ("scores", 1), ("reduce", 2)]
        # the diameter's MIN and MAX boxes (2 x 3 x 16 f32), then the [3, 5] scores
        assert reduces == [{"bytes": 2 * 3 * DIM * 4}, {"bytes": 3 * K * 4}]


def test_a_device_count_is_read_when_the_records_are(monkeypatch):
    """`count()` adds to the innermost open span: a 0-dim tensor (on the card
    a device value, the wide scan's `columns` and `sentences`) is kept as it
    is and read by `records()`, so a value written after the span closed is
    the one read; host integers add as they are.  Off, it touches no torch
    call (no synchronise, no launch) and records nothing."""
    t = torch.tensor(5)

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"torch.{name} called with tracing off")
    monkeypatch.setattr(profiling, "torch", Refuse())
    profiling.count(columns=t)                      # off, outside any span
    with profiling.span("scan"):
        profiling.count(columns=t)                  # off, inside the no-op
    monkeypatch.undo()
    assert profiling.records() == []
    with profiling.recording():
        profiling.count(columns=t)                  # on, outside every span
        with profiling.span("scan", queries=2):
            profiling.count(columns=t, sentences=3)
            with profiling.span("gather"):
                profiling.count(bytes=torch.tensor(7))
            profiling.count(columns=torch.tensor(4), sentences=1)
    (scan,) = [s for s in profiling._records if s.name == "scan"]
    assert scan.counts == {"queries": 2} and scan.added[0] == ("columns", t)
    t += 10                                         # the device writes it later
    recs = {r["name"]: r for r in profiling.records()}
    assert recs["scan"]["counts"] == {"queries": 2, "columns": 19, "sentences": 4}
    assert recs["gather"]["counts"] == {"bytes": 7}
    again = {r["name"]: r["counts"] for r in profiling.records()}   # read once
    assert again == {name: r["counts"] for name, r in recs.items()}
