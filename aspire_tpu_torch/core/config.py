"""Typed configuration for models and training runs (the port's own copy of
aspire_tpu/core/config.py: same fields, same run_info.json).

Replaces the reference's flat JSON hparam files + bash getopts glue
(config/models_config/*/*.json, bin/learning/run_main_fsim-ddp.sh).  The field
names intentionally mirror the reference JSON keys so existing config files
load unchanged (e.g. config/models_config/s2orccompsci/hparam_opt/
miswordbienc-otstuni-best.json:1-22).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass
class ModelHParams:
    """Model hyperparameters (reference JSON keys preserved)."""

    model_name: str = "miswordbienc"
    base_pt_layer: str = "allenai/specter"   # JSON key: "base-pt-layer"
    score_aggregation: str = "l2max"          # l2max | l2top2 | l2wasserstein | l2attention | jointsm | l2lse
    fine_tune: bool = True
    # Optimal-transport scoring params (pair_distances.py:16-19).
    geoml_blur: float = 0.05
    geoml_scaling: float = 0.9
    geoml_reach: float | None = None
    sent_sm_temp: float = 1.0
    cdatt_sm_temp: float = 1.0
    # Loss mixing proportions (disent_models.py:583-585,714-717).
    abs_loss_prop: float = 0.0
    sent_loss_prop: float = 1.0
    sentsup_loss_prop: float = 0.0
    cd_svalue_l1_prop: float = 0.0
    cd_l1_prop: float = 0.0
    weighted_sup: bool = False
    # Static-shape limits for the batch layout (reference caps:
    # batchers.py:569 -- 500 tokens; pp_settings.py:3 -- 20 sentences).
    max_seq_len: int = 512
    max_sents: int = 24
    consider_abs: bool = True
    # Attention backend for the BERT encoders (models/bert.py _select_impl):
    # 'auto' (the CUDA kernels on CUDA tensors, naive on the CPU), 'fused',
    # 'fused_det', 'naive' (materialised scores and masks).
    attention_impl: str = "auto"
    # Hidden/embedding dropout backend (models/bert.py _hidden_dropout):
    # 'auto' (the CUDA kernel on CUDA tensors), 'fused', 'naive' (a
    # materialised mask from the same Philox bits).
    hidden_dropout_impl: str = "auto"
    # FFN backend (models/bert.py _select_ffn): 'auto' (no-grad CUDA forwards
    # run the fused kernel; grad passes run plain products), 'fused', 'naive'
    # (linear-gelu-linear everywhere).
    ffn_impl: str = "auto"

    @property
    def consent(self) -> bool:
        """Whether the model emits per-sentence multi-vectors."""
        return self.model_name not in ("cospecter", "cosentbert", "ictsentbert")


@dataclasses.dataclass
class TrainHParams:
    """Training-loop hyperparameters (trainer.py + config JSON keys)."""

    train_suffix: str = "cocitabs"
    train_size: int = 0
    dev_size: int = 0
    num_epochs: int = 1
    batch_size: int = 3
    accumulated_batch_size: int = 30
    update_rule: str = "adam"
    learning_rate: float = 2e-5
    num_warmup_steps: int = 2000
    decay_lr_every: int = 1
    lr_decay_method: str = "warmuplin"   # warmuplin | warmupcosine | exponential
    decay_lr_by: float = 0.95
    es_check_every: int = 10000
    train_basepath: str = ""
    dev_path: str = ""


_MODEL_KEYS = {f.name for f in dataclasses.fields(ModelHParams)}
_TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainHParams)}


def _normalize(raw: dict[str, Any]) -> dict[str, Any]:
    out = dict(raw)
    if "base-pt-layer" in out:
        out["base_pt_layer"] = out.pop("base-pt-layer")
    return out


@dataclasses.dataclass
class RunConfig:
    """A full run: model + training hyperparameters.

    `from_json` accepts reference-format config files; `to_run_info` writes the
    `run_info.json` contract every downstream consumer re-reads
    (main_fsim.py:84-86, pp_gen_nearest.py:96-98).
    """

    model: ModelHParams
    train: TrainHParams
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "RunConfig":
        raw = _normalize(raw)
        model_kwargs = {k: v for k, v in raw.items() if k in _MODEL_KEYS}
        train_kwargs = {k: v for k, v in raw.items() if k in _TRAIN_KEYS}
        extra = {k: v for k, v in raw.items() if k not in _MODEL_KEYS | _TRAIN_KEYS}
        return cls(model=ModelHParams(**model_kwargs), train=TrainHParams(**train_kwargs), extra=extra)

    @classmethod
    def from_json(cls, path: str | pathlib.Path) -> "RunConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_flat_dict(self) -> dict[str, Any]:
        flat = {**dataclasses.asdict(self.model), **dataclasses.asdict(self.train), **self.extra}
        flat["base-pt-layer"] = flat.pop("base_pt_layer")
        return flat

    def to_run_info(self, path: str | pathlib.Path) -> None:
        """Persist the run_info.json contract (main_fsim.py:84-86)."""
        info = {"all_hparams": self.to_flat_dict()}
        with open(path, "w") as f:
            json.dump(info, f, indent=2)

    @classmethod
    def from_run_info(cls, path: str | pathlib.Path) -> "RunConfig":
        with open(path) as f:
            info = json.load(f)
        return cls.from_dict(info["all_hparams"])
