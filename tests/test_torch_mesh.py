"""parallel/mesh.py: the mesh builders, place, shard_batch, replicate and the
collectives' helpers on four gloo ranks on the CPU (spawned once for the
file), and the backend rule without any rank: nccl refuses ranks that share
a card and the CPU, and nothing falls back to gloo or to the CPU unasked."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aspire_tpu_torch.parallel import mesh as pm

WORLD = 4


def _errors(fn, *args):
    try:
        fn(*args)
    except ValueError as exc:
        return str(exc)
    return None


def _rank():
    out = {"errors": {
        "fewer": _errors(pm.make_mesh, 8),
        "more": _errors(pm.make_serving_mesh, 2),
        "grid": _errors(pm.make_train_serve_mesh, 3, 2)}}
    mesh = pm.make_train_serve_mesh(2, 2)
    data, serve = pm.make_mesh(), pm.make_serving_mesh(WORLD)
    out["coords"] = (mesh.index("data"), mesh.index("shard"),
                     data.index("data"), serve.index("shard"),
                     mesh.size("data"), mesh.size("shard"), mesh.world_size)
    x = np.arange(8 * 6).reshape(8, 6)
    out["place"] = {"whole": pm.place(x, mesh).numpy(),
                    "shard": pm.place(x, mesh, ("shard",)).numpy(),
                    "data1": pm.place(x, mesh, (None, "data")).numpy(),
                    "serve": pm.place(x, serve, ("shard",)).numpy()}
    out["uneven"] = _errors(pm.place, np.zeros((6, 2)), serve, ("shard",))
    sb = {"q": {"ids": np.arange(16).reshape(2, 8)}}
    out["shard_batch"] = (
        pm.shard_batch({"ids": np.arange(16).reshape(8, 2)}, data)["ids"].numpy(),
        pm.shard_batch(sb, data, axis=1)["q"]["ids"].numpy())
    # rank r's own values, then rank 0's everywhere
    torch.manual_seed(data.rank)
    module = torch.nn.Linear(3, 2)
    pm.replicate(module, data)
    tree = pm.replicate({"a": torch.full((2,), float(data.rank)),
                         "b": {"c": torch.tensor([data.rank])}}, data)
    out["replicate"] = ({k: v.detach().numpy() for k, v in
                         module.state_dict().items()},
                        tree["a"].numpy(), tree["b"]["c"].numpy())
    # a differentiable gather: the gradient of rank r's rows is the sum over
    # ranks of what each rank's loss asks of them
    x = torch.full((2, 3), float(data.rank + 1), requires_grad=True)
    gathered = pm.gather_rows(x, data)
    weights = torch.arange(2 * WORLD, dtype=torch.float32)[:, None] \
        * (data.rank + 1)
    (gathered * weights).sum().backward()
    out["gather"] = (gathered.detach().numpy(), x.grad.numpy(),
                     pm.gather_rows(torch.tensor([data.rank]), data).numpy())
    # sums over one axis of the 2-D mesh only
    out["reduce"] = (pm.all_reduce(torch.tensor([1.0 + data.rank]), mesh,
                                   "shard").numpy(),
                     pm.all_reduce(torch.tensor([1.0 + data.rank]), mesh,
                                   "data", dist.ReduceOp.MAX).numpy())
    return out


@pytest.fixture(scope="module")
def ranks():
    return pm.run_ranks(_rank, WORLD, device="cpu")


def test_mesh_builders_check_the_world_size(ranks):
    errors = ranks[0]["errors"]
    assert errors["fewer"] == "requested 8 data-parallel devices, only 4 available"
    assert errors["more"].startswith("requested 2 index shards, but the process "
                                     "group has 4 ranks")
    assert errors["grid"] == "requested 6 data x shard devices, only 4 available"


def test_coordinates_are_row_major(ranks):
    for r, res in enumerate(ranks):
        assert res["coords"] == (r // 2, r % 2, r, r, 2, 2, 4)


def test_place_gives_each_rank_its_slice(ranks):
    x = np.arange(8 * 6).reshape(8, 6)
    for r, res in enumerate(ranks):
        got = res["place"]
        np.testing.assert_array_equal(got["whole"], x)
        np.testing.assert_array_equal(got["shard"], x[4 * (r % 2):4 * (r % 2) + 4])
        np.testing.assert_array_equal(got["data1"], x[:, 3 * (r // 2):3 * (r // 2) + 3])
        np.testing.assert_array_equal(got["serve"], x[2 * r:2 * r + 2])
        assert "6 rows do not split over the 4 ranks" in res["uneven"]


def test_shard_batch_splits_the_chosen_axis(ranks):
    for r, res in enumerate(ranks):
        flat, micro = res["shard_batch"]
        np.testing.assert_array_equal(
            flat, np.arange(16).reshape(8, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            micro, np.arange(16).reshape(2, 8)[:, 2 * r:2 * r + 2])


def test_replicate_gives_every_rank_rank_0s_values(ranks):
    want, _, _ = ranks[0]["replicate"]
    torch.manual_seed(0)
    rank0 = torch.nn.Linear(3, 2).state_dict()
    for res in ranks:
        got, a, c = res["replicate"]
        for k in want:
            np.testing.assert_array_equal(got[k], rank0[k].numpy())
        np.testing.assert_array_equal(a, [0.0, 0.0])
        np.testing.assert_array_equal(c, [0])


def test_gather_rows_and_its_gradient(ranks):
    rows = np.repeat(np.arange(1, WORLD + 1, dtype=np.float32), 2)
    # d/dx_r of sum_s sum_i w_s[i] g[i] = sum_s (s + 1) * i over rank r's rows
    scale = sum(s + 1 for s in range(WORLD))
    for r, res in enumerate(ranks):
        gathered, grad, ints = res["gather"]
        np.testing.assert_array_equal(gathered, np.broadcast_to(rows[:, None],
                                                                (8, 3)))
        want = scale * np.arange(2 * r, 2 * r + 2, dtype=np.float32)
        np.testing.assert_array_equal(grad, np.broadcast_to(want[:, None],
                                                            (2, 3)))
        np.testing.assert_array_equal(ints, np.arange(WORLD))


def test_all_reduce_over_one_axis(ranks):
    for r, res in enumerate(ranks):
        shard_sum, data_max = res["reduce"]
        base = 2 * (r // 2)                 # the data row's first rank
        np.testing.assert_array_equal(shard_sum, [(base + 1) + (base + 2)])
        np.testing.assert_array_equal(data_max, [(r % 2) + 3])


@pytest.mark.parametrize("kw,match", [
    (dict(backend="nccl", device="cpu"), "nccl backend needs CUDA"),
    (dict(backend="nccl", device="cuda", colocate=True), "one rank a card"),
    (dict(backend="mpi", device="cpu"), "backend must be"),
])
def test_backend_rule(kw, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        pm.initialize_multihost("file://" + str(tmp_path / "r"), 2, 0, **kw)
    assert not dist.is_initialized()


def test_cuda_ranks_never_fall_back(monkeypatch):
    """A rank past the host's cards is refused, and on a machine without CUDA
    a CUDA rank raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(ValueError, match="would take cuda:3"):
        pm._rank_device_for(torch.device("cuda"), 3, False)
    assert pm._rank_device_for(torch.device("cuda"), 3, True) == \
        torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pm._rank_device_for(torch.device("cuda"), 0, False)


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        pm.make_mesh()
