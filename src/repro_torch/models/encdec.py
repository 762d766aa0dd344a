"""Whisper-style encoder-decoder backbone (the port of the JAX package's
``models/encdec.py``; arXiv:2212.04356).

The mel/conv frontend is a stub, as in JAX: the batch hands the model
precomputed frame embeddings (B, encoder_seq, d_model). The backbone is
a non-causal encoder (RoPE on its self-attention) and a causal decoder
whose blocks add cross-attention to the encoder's output (q of the
tokens against k, v of the frames, Sq != Skv, no RoPE), all on the flash
kernels in training. The param tree is JAX's: ``enc_pos``, ``encoder``
(stacked blocks), ``enc_norm``, ``embed``, ``body`` / ``tail`` (stacked
decoder blocks with ``self_attn``, ``ln_x`` and ``cross_attn``),
``final_norm``, ``lm_head``. The FES classifier is the decoder's tail,
final norm and head (``api.CLASSIFIER_KEYS``): the encoder belongs to
the frozen feature extractor. When ``cfg.remat`` is set each encoder and
decoder block runs under ``_Remat``, as the transformer's blocks run
under its ``_BlockRemat``: only the block's inputs are kept for the
backward, and the values are bitwise those without remat.

Serving: ``init_decode_cache`` encodes the frames once (the flash
forward), precomputes each decoder layer's cross K/V and allocates fresh
self-attention KV caches; ``decode_step`` and ``prefill`` (chunked
prefill, bit-identical to looping ``decode_step``) run every projection
on the row-invariant GEMM, every norm with the residual add before it on
the row-invariant RMSNorm (``layers.add_rmsnorm_serve``), the
self-attention on ``serve_attention`` and the cross-attention on its
cross form (``attention.cross_attention_decode``), as the dense family's
serving steps do. Caches are written in place. whisper's vocabulary
(51,865) is not a multiple of 8, which the bf16 GEMM's 16-byte weight
rows need on the card: ``serve_params`` gives the serving steps a copy
of ``lm_head`` padded once with zero columns (``invariant_dense.
pad_columns``), whose extra logits the steps drop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.invariant_dense import pad_columns
from repro_torch.models import attention as attn
from repro_torch.models.layers import (add_rmsnorm_serve,
                                       chunked_cross_entropy, dense,
                                       dense_init, dense_serve, embedding,
                                       embedding_init, mlp, mlp_init,
                                       mlp_serve, rmsnorm, rmsnorm_init)
from repro_torch.obs.timing import annotate
from repro_torch.utils.tree import leaves, tree_map, unflatten

#: the profiler's names (``obs.timing.annotate``) of the three kinds of
#: attention in training
ENC_ATTN, DEC_ATTN, CROSS_ATTN = ("encoder_attention", "decoder_attention",
                                  "cross_attention")


# ------------------------------------------------------------- params ------

def _enc_block_init(gen, cfg, dtype):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype),
            "attn": attn.attn_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.mlp_gated)}


def _dec_block_init(gen, cfg, dtype):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype),
            "self_attn": attn.attn_init(gen, cfg, dtype),
            "ln_x": rmsnorm_init(cfg.d_model, dtype),
            "cross_attn": attn.attn_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.mlp_gated)}


def _stack(gen, n, init_fn):
    """n blocks stacked on a leading layer axis (None when n == 0)."""
    if n == 0:
        return None
    blocks = [init_fn(gen) for _ in range(n)]
    return unflatten(blocks[0], [torch.stack(xs) for xs
                                 in zip(*(leaves(b) for b in blocks))])


def _groups(cfg):
    n_tail = min(cfg.fes_tail_layers, cfg.num_layers)
    return {"body": cfg.num_layers - n_tail, "tail": n_tail}


def init_params(cfg, gen: torch.Generator, device=None) -> dict:
    """The JAX package's tree, shapes and distributions, drawn from
    ``gen`` on the CPU and moved to ``device`` leaf by leaf."""
    dtype = getattr(torch, cfg.dtype)
    sizes = _groups(cfg)
    enc_pos = torch.randn((cfg.encoder_seq, cfg.d_model), generator=gen,
                          dtype=torch.float32, device=gen.device)
    params = {
        "enc_pos": (0.02 * enc_pos).to(dtype),
        "encoder": _stack(gen, cfg.encoder_layers,
                          lambda g: _enc_block_init(g, cfg, dtype)),
        "enc_norm": rmsnorm_init(cfg.d_model, dtype),
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "body": _stack(gen, sizes["body"],
                       lambda g: _dec_block_init(g, cfg, dtype)),
        "tail": _stack(gen, sizes["tail"],
                       lambda g: _dec_block_init(g, cfg, dtype)),
        "final_norm": rmsnorm_init(cfg.d_model, dtype),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }
    return tree_map(lambda x: x.to(device), params)


# ------------------------------------------------------------ forward ------

def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _enc_block(p, cfg, x):
    pos = _positions(x.shape[0], x.shape[1], x.device)
    with annotate(ENC_ATTN):
        h = attn.attention_fwd(p["attn"], cfg, rmsnorm(p["ln1"], x), pos,
                               causal=False, window=0)
    x = x + h
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x))


def _dec_block(p, cfg, x, enc_out):
    # one autograd node a block in front of the encoder output: the
    # gradients of its uses here (wk, wv) sum inside the block, as they
    # do under _Remat's vjp, so the encoder's gradient accumulates over
    # the blocks in the same order with remat on and off, bit for bit
    enc_out = enc_out.view_as(enc_out)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    enc_pos = _positions(B, enc_out.shape[1], x.device)
    with annotate(DEC_ATTN):
        h = attn.attention_fwd(p["self_attn"], cfg, rmsnorm(p["ln1"], x),
                               pos)
    x = x + h
    with annotate(CROSS_ATTN):
        h = attn.attention_fwd(p["cross_attn"], cfg, rmsnorm(p["ln_x"], x),
                               pos, causal=False, kv_x=enc_out,
                               kv_positions=enc_pos, window=0)
    x = x + h
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x))


class _Remat(torch.autograd.Function):
    """``block(p, cfg, *xs)`` under ``jax.checkpoint``: (block, like, cfg,
    n, *xs, *leaves) -> the block's output, ``xs`` its n float inputs
    (the residual stream; the decoder's also the encoder output),
    ``leaves`` its parameters in ``jax.tree`` order and ``like`` a tree
    of their shape. Only the inputs are saved; the backward runs the
    block again through ``torch.func.vjp`` (which composes with the
    cohorts' vmap) and returns detached gradients, as the transformer's
    ``_BlockRemat`` does. The vmap rule is generated: the kernels inside
    keep their own and launch once a call."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, like, cfg, n, *args):
        return block(unflatten(like, args[n:]), cfg, *args[:n])

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, like, cfg, n, *args = inputs
        ctx.save_for_backward(*args)
        ctx.block = (block, like, cfg, n)

    @staticmethod
    def backward(ctx, g):
        block, like, cfg, n = ctx.block

        def f(*a):
            return block(unflatten(like, a[n:]), cfg, *a[:n])

        _, vjp_fn = torch.func.vjp(f, *ctx.saved_tensors)
        return (None, None, None, None,
                *(x.detach() for x in vjp_fn(g)))


def _run(stacked, cfg, block, x, *extra):
    """Apply a stacked group, layer by layer (JAX: ``lax.scan``), each
    block under ``_Remat`` when ``cfg.remat``."""
    if stacked is None:
        return x
    for i in range(leaves(stacked)[0].shape[0]):
        p = tree_map(lambda a, i=i: a[i], stacked)
        if cfg.remat:
            x = _Remat.apply(block, tree_map(lambda _: 0, p), cfg,
                             1 + len(extra), x, *extra, *leaves(p))
        else:
            x = block(p, cfg, x, *extra)
    return x


def encode(params, cfg, frame_emb):
    """frame_emb (B, encoder_seq, d) -> the encoder's output (B,
    encoder_seq, d): the frames plus ``enc_pos``, the non-causal blocks,
    the final RMSNorm."""
    x = frame_emb.to(getattr(torch, cfg.dtype)) + params["enc_pos"][None]
    x = _run(params["encoder"], cfg, _enc_block, x)
    return rmsnorm(params["enc_norm"], x)


def hidden_states(params, cfg, batch):
    """batch: {"frame_emb": (B, encoder_seq, d), "tokens": (B, S)} ->
    the decoder's final-norm hidden states (B, S, d)."""
    enc_out = encode(params, cfg, batch["frame_emb"])
    x = embedding(params["embed"], batch["tokens"])
    for g in ("body", "tail"):
        x = _run(params[g], cfg, _dec_block, x, enc_out)
    return rmsnorm(params["final_norm"], x)


def forward(params, cfg, batch):
    """Full-sequence logits (B, S, V) and a zero aux loss."""
    x = hidden_states(params, cfg, batch)
    return (dense(params["lm_head"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg, batch):
    """Next-token CE over the decoder's tokens, chunked over the
    sequence."""
    x = hidden_states(params, cfg, batch)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1)
    return chunked_cross_entropy(x, params["lm_head"], labels, mask)


def prefill_logits(params, cfg, batch):
    """Last-position logits of a full batch (the flash forward)."""
    x = hidden_states(params, cfg, batch)
    return dense(params["lm_head"], x[:, -1, :])


# ------------------------------------------------------------- decode ------

def serve_params(params, cfg) -> dict:
    """The params the serving steps take: ``lm_head`` padded once with
    zero columns to a multiple of 8 where the vocabulary is not one
    (``invariant_dense.pad_columns``: the bf16 GEMM reads 16-byte weight
    rows), the rest shared with ``params``. The steps drop the padded
    logits."""
    head = params["lm_head"]
    w, b = pad_columns(head["w"], head.get("b"))
    if w is head["w"]:
        return params
    return dict(params, lm_head={"w": w} if b is None else {"w": w, "b": b})


def _split_kv(p, cfg, enc_out):
    hd = cfg.resolved_head_dim
    shape = (*enc_out.shape[:-1], cfg.num_kv_heads, hd)
    return (dense(p["wk"], enc_out).reshape(shape).contiguous(),
            dense(p["wv"], enc_out).reshape(shape).contiguous())


def init_decode_cache(params, cfg, frame_emb, max_len: int, dtype=None):
    """Encode once; precompute each decoder layer's cross K/V ((L, B,
    encoder_seq, KH, hd) stacked, a (k, v) pair a group, as JAX's vmap
    gives); fresh self-attention KV caches (``attention.init_kv_cache``)
    stacked on the layer axis. On the params' device; a group of no
    layers is None."""
    dtype = dtype or getattr(torch, cfg.dtype)
    enc_out = encode(params, cfg, frame_emb)
    B, device = enc_out.shape[0], enc_out.device
    cache = {}
    for g, n in _groups(cfg).items():
        if n == 0:
            cache[f"{g}_self"] = cache[f"{g}_cross"] = None
            continue
        one = attn.init_kv_cache(cfg, B, max_len, dtype, device)
        cache[f"{g}_self"] = {k: torch.stack([a] * n) for k, a in
                              one.items()}
        kvs = [_split_kv(tree_map(lambda a, i=i: a[i],
                                  params[g]["cross_attn"]), cfg, enc_out)
               for i in range(n)]
        cache[f"{g}_cross"] = (torch.stack([k for k, _ in kvs]),
                               torch.stack([v for _, v in kvs]))
    return cache


def _serve_blocks(stacked, cfg, x, r, self_c, cross_c, self_attend):
    """The decoder blocks of a group in a serving step: each norm takes
    the add before it into its launch (r, the previous block's MLP
    output, into ln1's), ``self_attend(p, n, cache)`` the block's
    self-attention, then the cross-attention against the layer's
    encoder K/V and the MLP. Returns (x, r)."""
    if stacked is None:
        return x, r
    for i in range(leaves(stacked)[0].shape[0]):
        p = tree_map(lambda a, i=i: a[i], stacked)
        x, n = add_rmsnorm_serve(p["ln1"], x, r)
        h = self_attend(p["self_attn"], n, {k: a[i] for k, a in
                                            self_c.items()})
        x, n = add_rmsnorm_serve(p["ln_x"], x, h)
        h = attn.cross_attention_decode(p["cross_attn"], cfg, n,
                                        cross_c[0][i], cross_c[1][i])
        x, n = add_rmsnorm_serve(p["ln2"], x, h)
        r = mlp_serve(p["mlp"], n)
    return x, r


def _head(params, cfg, x, r):
    _, n = add_rmsnorm_serve(params["final_norm"], x, r)
    y = dense_serve(params["lm_head"], n)
    return y if y.shape[-1] == cfg.vocab_size else y[..., :cfg.vocab_size]


def _step(params, cfg, x, cache, self_attend):
    r = None
    for g in ("body", "tail"):
        x, r = _serve_blocks(params[g], cfg, x, r, cache[f"{g}_self"],
                             cache[f"{g}_cross"], self_attend)
    return _head(params, cfg, x, r)


def decode_step(params, cfg, token, position, cache):
    """token: (B,) int; position: (B,) int32. Returns (logits (B, V),
    cache), the self-attention caches written in place."""
    x = embedding(params["embed"], token[:, None])
    logits = _step(params, cfg, x, cache, lambda p, n, c: attn.
                   attention_decode(p, cfg, n, c, position)[0])
    return logits[:, 0], cache


def prefill(params, cfg, tokens, positions, cache):
    """Chunked decoder prefill against the cached decode state (self-KV
    written blockwise; cross K/V read by every row). tokens/positions:
    (B, c); pad rows carry positions >= ``attention.PAD_FLOOR``. Returns
    (logits (B, c, V), cache), bit-identical to the per-token decode
    loop."""
    x = embedding(params["embed"], tokens)
    logits = _step(params, cfg, x, cache, lambda p, n, c: attn.
                   attention_prefill(p, cfg, n, c, positions)[0])
    return logits, cache
