"""Unified model API (the port of the JAX package's ``models/api.py``:
the paper CNN, the dense, moe, ssm (RWKV-6), hybrid (Zamba2) and vlm
(phi-3-vision) transformer families and the audio encoder-decoder
(whisper)):

    model = build_model(cfg)
    params = model.init(generator, device)
    loss   = model.loss(params, batch)
    logits, aux = model.forward(params, batch)
    mask   = model.fes_mask(params)        # paper Eq.(2): True = classifier
    logits, cache = model.decode_step(params, token, position, cache)

The serving surface of the transformer families: ``decode_step`` and
``init_decode_cache`` (every transformer family), ``prefill_logits``,
and, for the attention families (dense, moe and vlm) only (as in JAX:
the ssm and hybrid families decode through recurrent state, not a KV
ring), ``prefill`` and the paged entries ``init_paged_pool``,
``decode_step_paged``, ``prefill_paged``; ``None`` elsewhere. The audio
family serves through ``decode_step``, ``prefill`` and
``init_decode_cache(params, frame_emb, max_len)`` (the frames encoded
once), with no paged path (as in JAX), and ``serve_params`` (its
``lm_head`` padded for the card's GEMM; the identity elsewhere), which
the engines apply once when serving starts. Caches and pools are
allocated on the params' device
(``init_decode_cache(params, batch, max_len)``) or on the device given
(``init_paged_pool(num_blocks, block_size, device)``), and updated in
place by the steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, encdec, transformer
from repro_torch.utils.tree import leaves, tree_map

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
    #: last-position logits of a full batch (the flash forward)
    prefill_logits: Callable[[Any, Any], Any] | None = None
    #: chunked prefill(params, tokens, positions, cache) -> (logits, cache),
    #: bit-identical to looping decode_step (None: per-token only family)
    prefill: Callable[..., Any] | None = None
    init_paged_pool: Callable[..., Any] | None = None
    decode_step_paged: Callable[..., Any] | None = None
    prefill_paged: Callable[..., Any] | None = None
    #: params -> the params the serving steps take (applied once)
    serve_params: Callable[[Any], Any] = lambda p: p

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
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: encdec.init_params(cfg, gen,
                                                             device),
            loss=lambda p, b: encdec.loss_fn(p, cfg, b),
            forward=lambda p, b: encdec.forward(p, cfg, b),
            decode_step=lambda p, tok, pos, cache: encdec.decode_step(
                p, cfg, tok, pos, cache),
            init_decode_cache=lambda p, frame_emb, max_len:
            encdec.init_decode_cache(p, cfg, frame_emb, max_len),
            prefill_logits=lambda p, b: encdec.prefill_logits(p, cfg, b),
            prefill=lambda p, toks, pos, cache: encdec.prefill(
                p, cfg, toks, pos, cache),
            serve_params=lambda p: encdec.serve_params(p, cfg),
        )
    transformer.check_family(cfg)
    attn_family = cfg.family in ("dense", "moe", "vlm")
    tf = transformer
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: tf.init_params(cfg, gen, device),
        loss=lambda p, b: tf.loss_fn(p, cfg, b),
        forward=lambda p, b: tf.forward(p, cfg, b),
        decode_step=lambda p, tok, pos, cache: tf.decode_step(
            p, cfg, tok, pos, cache),
        init_decode_cache=lambda p, batch, max_len: tf.init_decode_cache(
            cfg, batch, max_len, device=_device_of(p)),
        prefill_logits=lambda p, b: tf.prefill_logits(p, cfg, b),
        prefill=(lambda p, toks, pos, cache: tf.prefill(
            p, cfg, toks, pos, cache)) if attn_family else None,
        init_paged_pool=(lambda nb, bs, device=None: tf.init_paged_pool(
            cfg, nb, bs, device=device)) if attn_family else None,
        decode_step_paged=(lambda p, tok, pos, pool, table, lw:
                           tf.decode_step_paged(p, cfg, tok, pos, pool,
                                                table, lw))
        if attn_family else None,
        prefill_paged=(lambda p, toks, pos, pool, table, lw:
                       tf.prefill_paged(p, cfg, toks, pos, pool, table, lw))
        if attn_family else None,
    )


def _device_of(params):
    """The device of a params tree (its first leaf's)."""
    return leaves(params)[0].device
