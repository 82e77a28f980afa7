"""The slice as a whole on the CPU: scripts/torch_e2e_chain.py's two-model
chain at a tiny size through aspire_tpu_torch.cli.main (`--device cpu
--tiny`, each training cut to 2 steps), held against the JAX package where
both run the same stage:

  * the synthesiser writes the batch files, vocabulary and evaluation
    dataset that scripts/e2e_chain.py writes from the same seed (equal
    bytes);
  * `preprocess gorc` writes the JAX pipeline's files (equal bytes);
  * the trained cosentbert, carried to the JAX package by models/convert.py,
    aligns the triples there as the port's `preprocess regen-examples` does
    (equal files but for alignments whose argmax leads by 1e-4 or less);
  * train -> build-index -> rank: finite losses, MAP and NDCG%20."""
import gzip
import importlib.util
import json
import math
import pathlib
import pickle

import numpy as np
import pytest
import torch

from aspire_tpu.data import align as jalign
from aspire_tpu.data import corpus as jcorpus
from aspire_tpu_torch import cli
from aspire_tpu_torch.models.convert import flax_params_from_model_state_dict

from test_torch_cli_preprocess import same_aligned_examples

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's chain at a tiny size, every stage run; returns its root."""
    mod = load_script("torch_e2e_chain")
    root = tmp_path_factory.mktemp("chain")
    sc = dict(mod.SCALES["pilot"], tiny=True, seq_len=64)
    mod.write_data(root, sc)
    summary = cli.main(mod.gorc_argv(root, 1, "cpu"))
    mod.write_configs(root, sc, summary["sent_examples"], summary["examples"], 2)
    cli.main(mod.sentenc_argv(root, sc, "cpu"))
    cli.main(mod.align_argv(root, "cpu"))
    cli.main(mod.train_argv(root, sc, "cpu"))
    cli.main(mod.index_argv(root, "cpu"))
    cli.main(mod.rank_argv(root, sc, "cpu"))
    return mod, root, summary


def test_synthesiser_writes_what_e2e_chain_writes(chain, tmp_path, monkeypatch):
    mod, root, summary = chain
    jax_script = load_script("e2e_chain")
    # the JAX script's data stage with its gorc pass stubbed out: only the
    # files it synthesises are compared
    monkeypatch.setattr(jcorpus, "run_gorc_pipeline", lambda *a, **k: summary)
    jax_script.stage_data(tmp_path, jax_script.SCALES["pilot"])
    for name in sorted(p.name for p in (root / "s2orc").iterdir()):
        with gzip.open(root / "s2orc" / name) as a, \
                gzip.open(tmp_path / "s2orc" / name) as b:
            assert a.read() == b.read(), name
    for rel in ("tokenizer/vocab.txt", "tokenizer/tokenizer_config.json",
                "eval/abstracts-syn.jsonl", "eval/test-pid2anns-syn.json",
                "eval/syn-evaluation_splits.json", "eval/corpus-index.jsonl"):
        assert (root / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel


def test_gorc_stage_matches_the_jax_pipeline(chain, tmp_path):
    mod, root, summary = chain
    want = jcorpus.run_gorc_pipeline(str(root / "s2orc"), str(tmp_path),
                                     processes=1, **mod.TRIPLE_LIMITS)
    assert summary == want and want["examples"]["train"] > 0
    for path in sorted(tmp_path.iterdir()):
        got = (root / "triples" / path.name).read_bytes()
        if path.suffix == ".pickle":
            assert pickle.loads(got) == pickle.loads(path.read_bytes())
        else:
            assert got == path.read_bytes(), path.name


def test_aligned_triples_match_the_jax_aligner_on_the_trained_weights(chain, tmp_path):
    import orbax.checkpoint as ocp
    mod, root, _ = chain
    run = root / "run-sentenc"
    jrun = tmp_path / "jax_run"
    jrun.mkdir()
    (jrun / "run_info.json").write_bytes((run / "run_info.json").read_bytes())
    tree = flax_params_from_model_state_dict(
        torch.load(run / "model_cur_best.pt"), "cosentbert")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((jrun / "model_cur_best").absolute(), tree, force=True)
    ckptr.wait_until_finished()
    embed = jalign.trained_sent_aligner(str(jrun), str(root / "tokenizer"))
    jcorpus.regenerate_examples(str(root / "triples"), str(tmp_path / "j"),
                                aligner=embed, **mod.TRIPLE_LIMITS)
    compared = 0
    for split in ("train", "dev"):
        compared += same_aligned_examples(
            root / "triples_enc" / f"{split}-cocitabsalign.jsonl",
            tmp_path / "j" / f"{split}-cocitabsalign.jsonl", embed)
    assert compared > 0


def test_trained_run_indexes_and_ranks(chain):
    mod, root, _ = chain
    for run in ("run-sentenc", "run"):
        losses = mod.train_losses(root / run)
        assert losses and all(math.isfinite(v) for _, v in losses)
    ranking = mod.score_ranking(root)
    values = list(ranking["map"].values()) + list(ranking["ndcg%20"].values())
    assert len(values) == 4 and all(0.0 <= v <= 1.0 for v in values)
    assert 0.0 < ranking["random_map"] < 1.0
    ranked = json.loads((root / "ranked" / "test-pid2pool-syn-sbalisentbienc-ranked.json")
                        .read_text())
    assert len(ranked) == 4 and all(len(v) == 48 for v in ranked.values())
    assert np.isfinite([s for v in ranked.values() for _, s in v]).all()
