"""Unified model API (the slice's part of the JAX package's
``models/api.py``):

    model = build_model(cfg)
    params = model.init(generator, device)
    loss   = model.loss(params, batch)
    logits, aux = model.forward(params, batch)
    mask   = model.fes_mask(params)        # paper Eq.(2): True = classifier
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn
from repro_torch.utils.tree import tree_map

# Top-level param keys that constitute the paper's "classifier" (omega^c).
CLASSIFIER_KEYS = ("tail", "final_norm", "lm_head", "fc1", "fc2", "fc3")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[[Any, Any], Any]
    forward: Callable[[Any, Any], Any]

    def fes_mask(self, params):
        """True leaves = trainable under FES (the classifier omega^c)."""
        return {k: tree_map(lambda _, k=k: k in CLASSIFIER_KEYS, v)
                for k, v in params.items()}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (the port "
            "has the paper CNN)")
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: cnn.init_params(cfg, gen, device),
        loss=lambda p, b: cnn.loss_fn(p, cfg, b),
        forward=lambda p, b: cnn.forward(p, cfg, b),
    )
