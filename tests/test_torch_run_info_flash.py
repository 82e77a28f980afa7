"""A run directory written by the JAX package with ``attention_impl: "flash"``
(its library attention backend, offered by its CLI) loads in the port as
``"auto"`` and encodes; the encode matches the JAX model on the same weights
(the JAX side encodes with its naive backend, which is what flash computes).
float32 at BertConfig.tiny(): rtol/atol 1e-4, two layers of f32 products and
LayerNorms in another summation order."""
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.config import (ModelHParams as JHP, RunConfig as JRC,
                                    TrainHParams as JTP)
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu_torch.core.config import RunConfig as TRC
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params

from test_torch_doc_models import MS, NO_DROP, T, feats, to_torch

HP = dict(model_name="sbalisentbienc", score_aggregation="l2wasserstein",
          sent_sm_temp=5000.0, max_sents=MS)


def _write_jax_run_info(path, impl):
    JRC(JHP(**HP, attention_impl=impl), JTP()).to_run_info(path)


def test_flash_run_info_loads_as_auto_and_logs_it(tmp_path, caplog):
    path = tmp_path / "run_info.json"
    _write_jax_run_info(path, "flash")
    with caplog.at_level(logging.INFO, logger="aspire_tpu_torch.core.config"):
        cfg = TRC.from_run_info(path)
    assert cfg.model.attention_impl == "auto"
    assert sum("flash" in r.getMessage() for r in caplog.records) == 1
    # every other backend name loads as it was written
    for impl in ("auto", "fused", "fused_det", "naive"):
        _write_jax_run_info(path, impl)
        assert TRC.from_run_info(path).model.attention_impl == impl


def test_flash_run_info_builds_a_model_that_encodes_like_jax(rng, tmp_path):
    path = tmp_path / "run_info.json"
    _write_jax_run_info(path, "flash")
    hp = TRC.from_run_info(path).model
    tmodel = tdm.build_model(hp, tb.BertConfig.tiny(**NO_DROP), device="cpu")
    jmodel = jdm.build_model(JHP(**HP, attention_impl="naive"),
                             jb.BertConfig.tiny(**NO_DROP))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0), seq_len=T))
    tmodel.load_state_dict(model_state_dict_from_flax_params(params, HP["model_name"]))
    tmodel.eval()
    batch = feats(rng, (3,))
    with torch.no_grad():
        cls, sents = tmodel.encode(to_torch(batch))
    j_cls, j_sents = jmodel.encode(params, jax.tree.map(jnp.asarray, batch))
    assert bool(torch.isfinite(sents.embed).all())
    np.testing.assert_allclose(cls.numpy(), np.asarray(j_cls), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sents.embed.numpy(), np.asarray(j_sents.embed),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="flash"):
        tb._select_impl("flash", True, 0.0)       # the backend itself stays unknown
