"""The port's twin of benchmarks/pool_bench.py (benchmarks/torch_pool_bench.py)
run with --device cpu at a tiny corpus: its four rows carry pool_bench.py's
keys, in its order, and its arguments are pool_bench.py's but for the
solver's names.  The pool ranking's parity with the JAX package is
tests/test_torch_pool_rank.py's."""
import ast

import pytest
import torch

from test_torch_bench import REPO, load_script, printed_keys, run_cpu


def parser_flags(path) -> dict:
    """--flag -> default of every add_argument call in a script."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            name = node.args[0].value
            default = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == "default"), None)
            flags[name] = default
    return flags


def test_pool_bench_rows_have_pool_bench_keys():
    want = printed_keys(REPO / "benchmarks" / "pool_bench.py")
    assert len(want) == 2            # the serving pool's row and the ladder's
    lines = run_cpu("torch_pool_bench.py", "--n-docs", "200", "--pool", "16",
                    "--batch", "2", "--iters", "2")
    rows = [ln for ln in lines if "metric" in ln]
    assert [r["metric"] for r in rows] == ["pool_rank_l2max", "pool_rank_ot",
                                           "score_chunk_l2max", "score_chunk_ot"]
    for row in rows:
        keys = want[0] if row["metric"].startswith("pool_rank") else want[1]
        assert list(row) == keys, row
    assert rows[1]["solver"] == "kernel" and rows[0]["solver"] == "n/a"
    assert (rows[0]["n_docs"], rows[0]["pool"], rows[0]["batch"]) == (200, 16, 2)
    assert (rows[2]["chunk"], rows[2]["smax"]) == (1024, 24)
    # a CPU run measures no card
    assert all(r["ms_per_query"] is None for r in rows[:2])


def test_pool_bench_arguments_are_pool_bench_s():
    jax_flags = parser_flags(REPO / "benchmarks" / "pool_bench.py")
    port_flags = parser_flags(REPO / "benchmarks" / "torch_pool_bench.py")
    for flag in ("--n-docs", "--pool", "--batch", "--sents", "--max-sents", "--qmax",
                 "--iters"):
        assert port_flags[flag] == jax_flags[flag], flag
    assert jax_flags["--solver"] == "pallas" and port_flags["--solver"] == "kernel"


@pytest.mark.parametrize("agg", ["l2max", "ot"])
def test_pool_bench_ranks_the_synthetic_bucket(agg):
    """The synthetic bucket in index.dense's layout: a pool ranking through it
    equals scoring each pool's candidate rows directly."""
    pb = load_script("torch_pool_bench")
    flat, pos = pb.synth_bucket(50, 3, 0, "cpu")
    assert flat[0].dtype == torch.bfloat16 and tuple(flat[0].shape) == (50, 3, 768)
    torch.testing.assert_close(flat[1], flat[0].float().square().sum(-1))
    q, q_lens, cand = pb.pool_queries(2, 4, 5, 50, 1, "cpu")
    got = pb.pool_ranker(5, 6, agg, "kernel")(q, q_lens, cand, *flat, *pos)
    from aspire_tpu_torch.core.types import MultiVec
    for i in range(2):
        reps = torch.zeros((5, 6, 768))
        reps[:, :3] = flat[0][cand[i].long()].float()
        qt = MultiVec(q[i:i + 1].expand(5, 4, 768), q_lens[i:i + 1].expand(5))
        want = pb.chunk_scorer(agg, "torch")(qt, MultiVec(reps, torch.full((5,), 3)))
        torch.testing.assert_close(got[i], want, atol=2e-3, rtol=2e-3)
