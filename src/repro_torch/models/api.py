"""Unified model API (the port's part of the JAX package's
``models/api.py``: the paper CNN and the dense and ssm (RWKV-6)
transformer families):

    model = build_model(cfg)
    params = model.init(generator, device)
    loss   = model.loss(params, batch)
    logits, aux = model.forward(params, batch)
    mask   = model.fes_mask(params)        # paper Eq.(2): True = classifier

The serving surface (``decode_step``, ``init_decode_cache``, ``prefill``
and the paged entries) stays ``None`` until the serving slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, transformer
from repro_torch.utils.tree import tree_map

# Top-level param keys that constitute the paper's "classifier" (omega^c).
CLASSIFIER_KEYS = ("tail", "final_norm", "lm_head", "fc1", "fc2", "fc3")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[[Any, Any], Any]
    forward: Callable[[Any, Any], Any]
    decode_step: Callable[..., Any] | None = None
    init_decode_cache: Callable[..., Any] | None = None
    prefill: Callable[..., Any] | None = None
    init_paged_pool: Callable[..., Any] | None = None
    decode_step_paged: Callable[..., Any] | None = None
    prefill_paged: Callable[..., Any] | None = None

    def fes_mask(self, params):
        """True leaves = trainable under FES (the classifier omega^c)."""
        return {k: tree_map(lambda _, k=k: k in CLASSIFIER_KEYS, v)
                for k, v in params.items()}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: cnn.init_params(cfg, gen, device),
            loss=lambda p, b: cnn.loss_fn(p, cfg, b),
            forward=lambda p, b: cnn.forward(p, cfg, b),
        )
    transformer.check_family(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: transformer.init_params(cfg, gen,
                                                              device),
        loss=lambda p, b: transformer.loss_fn(p, cfg, b),
        forward=lambda p, b: transformer.forward(p, cfg, b),
    )
