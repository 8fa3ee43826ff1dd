"""Typed model configuration for the PyTorch port.

A copy of ``factorized_tpu.config.MFMConfig``'s fields (the port imports
nothing of the JAX package), with ``to_dict`` / ``from_dict`` for
checkpoint metadata, ``from_json`` for the ``configs/*.json`` files (and
the reference's legacy schema), ``to_legacy`` for the run log's first
line, ``replace``, the derived sizes, the random-search draw
``sample_search_config`` (the same draws as the JAX package's for one
``random.Random``), the pinned MOSI config ``best_acc_mosi_config`` and
the pinned MFN-baseline configs ``best_mfn_mosi_config``.
"""

from __future__ import annotations

import dataclasses
import json
import random
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class MFMConfig:
    # dataset-fixed
    input_dims: List[int] = field(default_factory=lambda: [300, 5, 20])
    output_dim: int = 1
    seqlength: int = 20

    # architecture
    h_dims: List[int] = field(default_factory=lambda: [88, 64, 48])
    zy_size: int = 32
    zl_size: int = 32
    za_size: int = 8
    zv_size: int = 80
    fy_size: int = 16
    fl_size: int = 88
    fa_size: int = 8
    fv_size: int = 8
    memsize: int = 64
    windowsize: int = 2

    # dropouts
    zy_to_fy_dropout: float = 0.0
    zl_to_fl_dropout: float = 0.2
    za_to_fa_dropout: float = 0.2
    zv_to_fv_dropout: float = 0.7
    fy_to_y_dropout: float = 0.0

    # MFN attention/gate networks (NN1 / NN2 / gamma1 / gamma2 / out)
    att1_shape: int = 128
    att1_drop: float = 0.5
    att2_shape: int = 128
    att2_drop: float = 0.5
    gamma1_shape: int = 128
    gamma1_drop: float = 0.5
    gamma2_shape: int = 128
    gamma2_drop: float = 0.5
    out_shape: int = 64
    out_drop: float = 0.5

    # loss weights
    lda_mmd: float = 1.0
    lda_xl: float = 1.0
    lda_xa: float = 0.01
    lda_xv: float = 0.5

    # experiment selection
    model_type: str = "mfm"
    missing: int = 0
    zeros: int = 0
    task: str = "regression"  # regression | classification

    # optimization
    batchsize: int = 32
    num_epochs: int = 30
    lr: float = 1e-3
    momentum: float = 0.9
    seed: int = 123

    @property
    def total_h_dim(self) -> int:
        return sum(self.h_dims)

    @property
    def last_mfn_size(self) -> int:
        return self.total_h_dim + self.memsize

    @property
    def d_total(self) -> int:
        return sum(self.input_dims)

    @classmethod
    def from_dict(cls, d: dict) -> "MFMConfig":
        """Build from a ``to_dict`` mapping (e.g. a checkpoint's
        ``meta.json``); keys that are not fields are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str, **overrides) -> "MFMConfig":
        """Read a ``configs/*.json`` file: the fields it names (others
        ignored), the legacy keys ``inputdims`` and ``seqlength`` of the
        reference's schema, then ``overrides``."""
        with open(path) as f:
            raw = json.load(f)
        kw = {}
        if "inputdims" in raw:  # legacy schema (reference configs/*.json)
            kw["input_dims"] = list(raw["inputdims"])
        if "seqlength" in raw:
            kw["seqlength"] = raw["seqlength"]
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in raw.items():
            if k in names:
                kw[k] = v
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw) -> "MFMConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self):
        return dataclasses.asdict(self)

    def to_legacy(self):
        """The reference's six-dict layout of the config: the model dict,
        then the att1, att2, gamma1, gamma2 and out MLPs' shapes and
        dropouts. A run's log opens with it, as the JAX package's does."""
        config = {
            "input_dims": list(self.input_dims),
            "h_dims": list(self.h_dims),
            "zy_size": self.zy_size, "zl_size": self.zl_size,
            "za_size": self.za_size, "zv_size": self.zv_size,
            "fy_size": self.fy_size, "fl_size": self.fl_size,
            "fa_size": self.fa_size, "fv_size": self.fv_size,
            "memsize": self.memsize,
            "zy_to_fy_dropout": self.zy_to_fy_dropout,
            "zl_to_fl_dropout": self.zl_to_fl_dropout,
            "za_to_fa_dropout": self.za_to_fa_dropout,
            "zv_to_fv_dropout": self.zv_to_fv_dropout,
            "fy_to_y_dropout": self.fy_to_y_dropout,
            "lda_mmd": self.lda_mmd, "lda_xl": self.lda_xl,
            "lda_xa": self.lda_xa, "lda_xv": self.lda_xv,
            "type": self.model_type, "missing": self.missing,
            "zeros": self.zeros, "output_dim": self.output_dim,
            "windowsize": self.windowsize, "batchsize": self.batchsize,
            "num_epochs": self.num_epochs, "lr": self.lr,
            "momentum": self.momentum,
        }
        return [
            config,
            {"shapes": self.att1_shape, "drop": self.att1_drop},
            {"shapes": self.att2_shape, "drop": self.att2_drop},
            {"shapes": self.gamma1_shape, "drop": self.gamma1_drop},
            {"shapes": self.gamma2_shape, "drop": self.gamma2_drop},
            {"shapes": self.out_shape, "drop": self.out_drop},
        ]


# ---- search spaces (the reference's random.choice lists) ---------------

_COMMON = dict(
    hl=[32, 64, 88, 128, 156, 256],
    small=[8, 16, 32, 48, 64, 80],
    zl=[32, 64, 88, 128, 156, 256],
    mem=[64, 128, 256, 300, 400],
    drop=[0.0, 0.2, 0.5, 0.7],
    batch=[32, 64, 128],
)


def sample_search_config(dataset: str, rng: Optional[random.Random] = None,
                         **overrides) -> MFMConfig:
    """One random-search draw, the per-dataset choice lists of the
    reference (``mfm_mosi.py:1302-1353``, ``mfm_moud.py:615-665``,
    ``mfm_you.py:592-645``, ``mfm_mmmo.py:676-729``), drawn in the JAX
    package's order, so one ``random.Random(seed)`` gives the same
    configs in both."""
    r = rng or random
    c = _COMMON
    if dataset in ("mosi_sdk", "mosei_sdk"):
        # the SDK csd files: the mosi search space, their feature widths
        # set by the caller from the loaded data
        dataset = "mosi"
    if dataset == "mosi":
        input_dims, output_dim = [300, 5, 20], 1
        lda_mmd = [10, 50, 100, 200]
        lda_x = [0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0]
        lrs = [0.001, 0.002, 0.005, 0.008, 0.01, 0.02]
        shapes = [32, 64, 128, 256]
        task = "regression"
    elif dataset in ("moud", "you", "youtube", "mmmo"):
        input_dims = [300, 74, 36]
        output_dim = {"moud": 2, "mmmo": 1}.get(dataset, 3)
        lda_mmd = [10, 50, 100, 200]
        lda_x = [0.01, 0.1, 0.5, 1.0, 5.0]
        lrs = [0.001, 0.002, 0.004, 0.005, 0.008, 0.01, 0.02]
        shapes = [32, 64, 128]
        task = "regression" if dataset == "mmmo" else "classification"
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    cfg = MFMConfig(
        input_dims=input_dims,
        output_dim=output_dim,
        task=task,
        h_dims=[r.choice(c["hl"]), r.choice(c["small"]), r.choice(c["small"])],
        zy_size=r.choice(c["small"]),
        zl_size=r.choice(c["zl"]),
        za_size=r.choice(c["small"]),
        zv_size=r.choice(c["small"]),
        fy_size=r.choice(c["small"]),
        fl_size=r.choice(c["zl"]),
        fa_size=r.choice(c["small"]),
        fv_size=r.choice(c["small"]),
        memsize=r.choice(c["mem"]),
        zy_to_fy_dropout=r.choice(c["drop"]),
        zl_to_fl_dropout=r.choice(c["drop"]),
        za_to_fa_dropout=r.choice(c["drop"]),
        zv_to_fv_dropout=r.choice(c["drop"]),
        fy_to_y_dropout=r.choice(c["drop"]),
        lda_mmd=r.choice(lda_mmd),
        lda_xl=r.choice(lda_x),
        lda_xa=r.choice(lda_x),
        lda_xv=r.choice(lda_x),
        batchsize=r.choice(c["batch"]),
        num_epochs=50,
        lr=r.choice(lrs),
        att1_shape=r.choice(shapes), att1_drop=r.choice(c["drop"]),
        att2_shape=r.choice(shapes), att2_drop=r.choice(c["drop"]),
        gamma1_shape=r.choice(shapes), gamma1_drop=r.choice(c["drop"]),
        gamma2_shape=r.choice(shapes), gamma2_drop=r.choice(c["drop"]),
        out_shape=r.choice(shapes), out_drop=r.choice(c["drop"]),
    )
    return cfg.replace(**overrides) if overrides else cfg


def best_acc_mosi_config(**overrides) -> MFMConfig:
    """The pinned known-good MOSI MFM config (``mfm_mosi.py:1227-1288``)."""
    cfg = MFMConfig(
        input_dims=[300, 5, 20],
        h_dims=[88, 64, 48],
        zy_size=32, zl_size=32, za_size=8, zv_size=80,
        fy_size=16, fl_size=88, fa_size=8, fv_size=8,
        memsize=64,
        zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
        za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7,
        fy_to_y_dropout=0.0,
        lda_mmd=1.0, lda_xl=1.0, lda_xa=0.01, lda_xv=0.5,
        model_type="mfm", missing=0, output_dim=1,
        windowsize=2, batchsize=32, num_epochs=30,
        lr=0.01, momentum=0.9,
        att1_shape=128, att1_drop=0.5,
        att2_shape=128, att2_drop=0.5,
        gamma1_shape=128, gamma1_drop=0.5,
        gamma2_shape=128, gamma2_drop=0.5,
        out_shape=64, out_drop=0.5,
    )
    return cfg.replace(**overrides) if overrides else cfg


def best_mfn_mosi_config(kind: str = "mae", **overrides) -> MFMConfig:
    """The recorded best MFN-baseline configs on MOSI
    (``test_mosi.py:537-547``): kind='mae' -> MAE 0.993 search result,
    kind='acc' -> 77.0% binary accuracy result."""
    if kind == "mae":
        cfg = MFMConfig(
            input_dims=[300, 5, 20], h_dims=[88, 48, 16], memsize=128,
            windowsize=2, batchsize=128, num_epochs=100, lr=0.01,
            momentum=0.9,
            att1_shape=128, att1_drop=0.0,
            att2_shape=64, att2_drop=0.2,
            gamma1_shape=256, gamma1_drop=0.0,
            gamma2_shape=64, gamma2_drop=0.2,
            out_shape=64, out_drop=0.5,
            model_type="mfn",
        )
    elif kind == "acc":
        cfg = MFMConfig(
            input_dims=[300, 5, 20], h_dims=[64, 8, 80], memsize=400,
            windowsize=2, batchsize=128, num_epochs=100, lr=0.005,
            momentum=0.9,
            att1_shape=128, att1_drop=0.5,
            att2_shape=128, att2_drop=0.2,
            gamma1_shape=128, gamma1_drop=0.5,
            gamma2_shape=128, gamma2_drop=0.5,
            out_shape=256, out_drop=0.5,
            model_type="mfn",
        )
    else:
        raise ValueError(f"kind must be 'mae' or 'acc', got {kind!r}")
    return cfg.replace(**overrides) if overrides else cfg
