"""The decoder stack of the dense, moe, ssm (RWKV-6), hybrid (Zamba2) and
vlm (phi-3-vision) families (the port of the JAX package's
``models/transformer.py``). A block with
``cfg.num_experts`` carries ``moe`` (``models/moe.py``) where a dense
block carries ``mlp``, as in JAX: its aux loss flows into ``loss_fn``'s
``0.01 * aux``. A hybrid block is a Mamba-2 block (``models/mamba2.py``)
behind one RMSNorm; the stack applies ONE shared attention block
(``shared_attn``: its own RMSNorm and attention, reused across depth)
after every group of ``cfg.attn_every`` blocks, for the body and, in
training, the tail, exactly where JAX's ``_scan_blocks`` does; the
shared attention is not under remat (JAX checkpoints the block, not the
group). The vlm family is the dense stack behind ``vision_proj``: the
batch's precomputed patch embeddings (B, num_patches, vision_dim),
projected to d_model, go before the token embeddings, positions 0..S-1
run over both, and the loss is taken on the text segment only; it
serves as the dense family does, on tokens alone (JAX's ``prefill`` and
``decode_step`` take no patches). The encoder-decoder (audio) family is
``models/encdec.py``.

The stack is split into BODY and TAIL block groups so the paper's FES
scheme (feature extractor = embed + body; classifier = tail + final norm
+ lm head) is a param-tree boundary. Blocks are stacked on a leading
layer axis under ``body`` and ``tail``, as in the JAX tree, and applied
by a Python loop over that axis (JAX: ``lax.scan``).

When ``cfg.remat`` is set, each block is applied as JAX's
``jax.checkpoint(body)`` applies it: ``_BlockRemat`` keeps only the
block's input (and its parameters, which are alive anyway) between the
forward and the backward, and the backward runs the block again to take
its vector-Jacobian product. That changes memory, not values: the loss
and every gradient are bitwise those of the stack without remat, on the
CPU and, with the deterministic kernels, on the card.

Serving: ``init_decode_cache``, ``decode_step`` (every family),
``prefill`` (chunked prefill of the dense family: one call a prompt
CHUNK, bit-identical to looping ``decode_step``), ``init_paged_pool``,
``decode_step_paged``, ``prefill_paged`` and ``prefill_logits``. Caches
and pools are stacked on the layer axis like the parameters, allocated on
the caller's device, and written IN PLACE: each call returns the same
tensors it was given (JAX returns new ones, which its engines donate).
The dense family's serving steps run every projection (7 a layer in 4
launches: wq|wk|wv and w_in|w_gate grouped; and ``lm_head``) and every
RMSNorm (2 a layer and the final norm) on the row-invariant kernels
(``layers.dense_serve``, ``dense_serve_group``, ``mlp_serve``,
``add_rmsnorm_serve``; a moe block's experts through ``moe.moe_serve``,
1 + 3 E / 2 launches in place of the MLP's 2): on the card a row's
result does not depend on how many rows the step carries, so chunked
prefill equals the per-token loop there too. A dense serving block takes the residual stream x and
``r``, the previous block's MLP output not yet added (None before the
first block), and returns the same pair: each norm takes the add before
it into its own launch (``x, n = add_rmsnorm_serve(ln, x, r)``), the
final norm the last block's. The ssm and hybrid families serve per token
only and keep ``dense`` / ``rmsnorm`` (the hybrid's shared attention
decodes through ``attention.attention_decode``: ``serve_attention`` and
the row-invariant projections, over G = n_body // attn_every KV caches,
``cache["shared"]``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.layers import (add_rmsnorm_serve,
                                       chunked_cross_entropy, dense,
                                       dense_init, dense_serve, embedding,
                                       embedding_init, mlp, mlp_init,
                                       mlp_serve, rmsnorm, rmsnorm_init)
from repro_torch.obs.timing import annotate
from repro_torch.utils.tree import leaves, tree_map, unflatten

#: the profiler's name (``obs.timing.annotate``) of a shared-attention
#: site of the hybrid family in training
SHARED_ATTN = "shared_attention"


def check_family(cfg) -> None:
    family = cfg.family
    if family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        where = ("; the audio family is models/encdec.py"
                 if family == "audio" else "")
        raise NotImplementedError(
            f"model family {family!r} ({cfg.name}) has no decoder stack "
            f"in models/transformer.py{where}")


# ------------------------------------------------------------- blocks ------

def block_init(gen: torch.Generator, cfg, dtype) -> dict:
    """One block of the config's family."""
    check_family(cfg)
    if cfg.family == "ssm":                       # rwkv6
        return {"rwkv": rwkv6.rwkv6_init(gen, cfg, dtype),
                "ln1": rmsnorm_init(cfg.d_model, dtype),
                "ln2": rmsnorm_init(cfg.d_model, dtype)}
    if cfg.family == "hybrid":                    # zamba2 mamba block
        return {"mamba": mamba2.mamba2_init(gen, cfg, dtype),
                "ln": rmsnorm_init(cfg.d_model, dtype)}
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype),
         "ln2": rmsnorm_init(cfg.d_model, dtype),
         "attn": attn.attn_init(gen, cfg, dtype)}
    if cfg.num_experts:
        p["moe"] = moe.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.mlp_gated)
    return p


def _stacked_block_init(gen: torch.Generator, cfg, n: int, dtype):
    """n blocks stacked on a leading layer axis (None when n == 0)."""
    if n == 0:
        return None
    blocks = [block_init(gen, cfg, dtype) for _ in range(n)]
    return unflatten(blocks[0], [torch.stack(xs) for xs
                                 in zip(*(leaves(b) for b in blocks))])


def block_fwd(p, cfg, x, positions, aux):
    """Full-sequence block application. Returns (x, aux). An rwkv6 or
    mamba2 block starts from a fresh zero state and drops the new one, as
    in the JAX package."""
    if cfg.family == "ssm":
        st = rwkv6.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
        h, st = rwkv6.time_mix(p["rwkv"], cfg, rmsnorm(p["ln1"], x), st)
        x = x + h
        h, _ = rwkv6.channel_mix(p["rwkv"], rmsnorm(p["ln2"], x), st)
        return x + h, aux
    if cfg.family == "hybrid":
        st = mamba2.init_mamba_state(cfg, x.shape[0], x.dtype, x.device)
        h, _ = mamba2.mamba2_fwd(p["mamba"], cfg, rmsnorm(p["ln"], x), st)
        return x + h, aux
    h = attn.attention_fwd(p["attn"], cfg, rmsnorm(p["ln1"], x), positions)
    x = x + h
    if cfg.num_experts:
        h, a = moe.moe_apply(p["moe"], cfg, rmsnorm(p["ln2"], x))
        aux = aux + a
    else:
        h = mlp(p["mlp"], rmsnorm(p["ln2"], x))
    return x + h, aux


class _BlockRemat(torch.autograd.Function):
    """``block_fwd`` under ``jax.checkpoint``: (x, aux, positions, like,
    cfg, *leaves) -> (x, aux), where ``leaves`` are the block's parameter
    leaves in ``jax.tree`` order and ``like`` a tree of their shape. The
    forward runs the block without keeping its intermediates (a
    Function's forward runs without autograd); only the inputs are
    saved. The backward recomputes the block through ``torch.func.vjp``,
    which, unlike ``torch.autograd.grad``, composes with the ``vmap``
    over cohorts that the client plane runs (``torch.utils.checkpoint``
    does not: it raises under ``torch.func`` transforms). The vmap rule
    is generated: the block runs once on the batched tensors, so the
    kernels inside keep their own vmap rules and launch once a call."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, aux, positions, like, cfg, *flat):
        x, aux_out = block_fwd(unflatten(like, flat), cfg, x, positions,
                               aux)
        # an output may not be an input of the Function
        return x, aux_out.clone() if aux_out is aux else aux_out

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, aux, positions, like, cfg, *flat = inputs
        ctx.save_for_backward(x, aux, positions, *flat)
        ctx.block = (like, cfg)

    @staticmethod
    def backward(ctx, gx, gaux):
        x, aux, positions, *flat = ctx.saved_tensors
        like, cfg = ctx.block

        def block(x, aux, *flat):
            return block_fwd(unflatten(like, flat), cfg, x, positions, aux)

        _, vjp_fn = torch.func.vjp(block, x, aux, *flat)
        grads = vjp_fn((gx, gaux))
        # torch.func's grad runs its backward with create_graph=True, so
        # the recompute is recorded at its level too; returning detached
        # gradients drops that record with this call, or it would keep
        # every block's recomputed activations to the end of the backward
        gx, gaux, *gflat = (g.detach() for g in grads)
        return (gx, gaux, None, None, None, *gflat)


def _apply_block(stacked, i, cfg, x, positions, aux):
    """Block ``i`` of a stacked group, under ``_BlockRemat`` when
    ``cfg.remat``."""
    p = tree_map(lambda a: a[i], stacked)
    if cfg.remat:
        return _BlockRemat.apply(x, aux, positions, tree_map(lambda _: 0, p),
                                 cfg, *leaves(p))
    return block_fwd(p, cfg, x, positions, aux)


def _shared_groups(cfg, L: int, shared) -> int:
    """G, the groups of ``cfg.attn_every`` blocks of a stack of L that a
    shared attention block follows (0 outside the hybrid family, without
    ``shared`` params or when L < attn_every), as JAX's ``_scan_blocks``
    and ``_scan_blocks_decode`` group them."""
    if (cfg.family == "hybrid" and cfg.attn_every and shared is not None
            and L >= cfg.attn_every):
        return L // cfg.attn_every
    return 0


def _run_blocks(stacked, cfg, x, positions, aux, shared_attn=None):
    """Apply a stacked group of blocks, layer by layer, each under
    ``_BlockRemat`` when ``cfg.remat``. In the hybrid family the shared
    attention block (``shared_attn``, outside remat) follows each of the
    first G groups of ``cfg.attn_every`` blocks (``_shared_groups``); the
    remaining blocks come after the last site."""
    if stacked is None:
        return x, aux
    L = leaves(stacked)[0].shape[0]
    G, per = _shared_groups(cfg, L, shared_attn), cfg.attn_every
    for i in range(L):
        x, aux = _apply_block(stacked, i, cfg, x, positions, aux)
        if i < G * per and (i + 1) % per == 0:
            with annotate(SHARED_ATTN):
                x = x + attn.attention_fwd(
                    shared_attn["attn"], cfg,
                    rmsnorm(shared_attn["ln"], x), positions)
    return x, aux


# ------------------------------------------------------------- params ------

def init_params(cfg, gen: torch.Generator, device=None) -> dict:
    """The JAX package's tree, shapes and distributions, drawn from
    ``gen`` on the CPU (so a seed gives the same params on every device)
    and moved to ``device`` leaf by leaf."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    n_tail = min(cfg.fes_tail_layers, cfg.num_layers)
    n_body = cfg.num_layers - n_tail
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "body": _stacked_block_init(gen, cfg, n_body, dtype),
        "tail": _stacked_block_init(gen, cfg, n_tail, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }
    if cfg.family == "hybrid" and cfg.attn_every:
        acfg = cfg.with_(num_heads=cfg.num_heads or 32,
                         num_kv_heads=cfg.num_kv_heads or 32)
        params["shared_attn"] = {"attn": attn.attn_init(gen, acfg, dtype),
                                 "ln": rmsnorm_init(cfg.d_model, dtype)}
    if cfg.family == "vlm":
        params["vision_proj"] = dense_init(
            gen, cfg.vision_dim or cfg.d_model, cfg.d_model, dtype)
    return tree_map(lambda x: x.to(device), params)


# ------------------------------------------------------------ forward ------

def embed_inputs(params, cfg, batch):
    """Returns (x, positions): the token embeddings and the aligned
    positions 0..S-1. The vlm family puts ``vision_proj`` of the batch's
    ``patch_emb`` (cast to the model dtype) before the tokens."""
    x = embedding(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        pe = dense(params["vision_proj"], batch["patch_emb"].to(x.dtype))
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def hidden_states(params, cfg, batch):
    """Final-norm hidden states (no logits) and the aux loss (the moe
    blocks' summed; 0 for the other families). The hybrid family's
    shared attention goes to the body and the tail, as in JAX's
    ``forward``."""
    x, positions = embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_attn")
    x, aux = _run_blocks(params["body"], cfg, x, positions, aux, shared)
    x, aux = _run_blocks(params["tail"], cfg, x, positions, aux, shared)
    return rmsnorm(params["final_norm"], x), aux


def forward(params, cfg, batch):
    """Full-sequence logits (B, S, V) and the aux loss."""
    x, aux = hidden_states(params, cfg, batch)
    return dense(params["lm_head"], x), aux


def loss_fn(params, cfg, batch):
    """Next-token CE (+ 0.01 x the aux loss), chunked over the sequence
    so the logits never form at (B, S, V). The vlm family's loss is on
    the text segment only."""
    x, aux = hidden_states(params, cfg, batch)
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        x = x[:, -tokens.shape[1]:, :]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1)
    loss = chunked_cross_entropy(x, params["lm_head"], labels, mask)
    return loss + 0.01 * aux


def prefill_logits(params, cfg, batch):
    """Full-sequence prefill, last-position logits only (the flash
    forward; full (B, S, V) logits are never formed). The cache-writing
    chunked prefill for serving is ``prefill`` below."""
    x, _ = hidden_states(params, cfg, batch)
    return dense(params["lm_head"], x[:, -1, :])


# ------------------------------------------------------------- decode ------

def _groups(cfg):
    n_tail = min(cfg.fes_tail_layers, cfg.num_layers)
    return {"body": cfg.num_layers - n_tail, "tail": n_tail}


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None,
                      device=None) -> dict:
    """Per-layer decode state stacked on the layer axis, per group: the
    KV cache (``attention.init_kv_cache``) of the dense family, the
    recurrent state of the ssm (``rwkv6.init_rwkv_state``) and hybrid
    (``mamba2.init_mamba_state``) families; the hybrid family's shared
    attention adds ``shared``, G = n_body // attn_every KV caches (one a
    site of the body; JAX's decode gives the tail none)."""
    check_family(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)

    def stack(one, n):
        return {k: torch.stack([a] * n) for k, a in one.items()}

    def group(n):
        if n == 0:
            return None
        if cfg.family == "ssm":
            return stack(rwkv6.init_rwkv_state(cfg, batch, dtype, device), n)
        if cfg.family == "hybrid":
            return stack(mamba2.init_mamba_state(cfg, batch, dtype, device),
                         n)
        return stack(attn.init_kv_cache(cfg, batch, max_len, dtype, device),
                     n)

    sizes = _groups(cfg)
    cache = {g: group(n) for g, n in sizes.items()}
    if cfg.family == "hybrid" and cfg.attn_every:
        G = sizes["body"] // cfg.attn_every
        if G > 0:
            cache["shared"] = stack(attn.init_kv_cache(
                cfg, batch, max_len, dtype, device), G)
    return cache


def _layer(tree, i):
    return {k: a[i] for k, a in tree.items()}


def _serve_block(p, cfg, x, r, attend):
    """An attention block of a serving step: the residual r added in
    ln1's launch, ``attend(n)`` the block's attention output on ln1's
    output, added in ln2's launch, then the MLP (``moe.moe_serve`` in a
    moe block). Every serving path applies its attention blocks through
    this, so their residual streams match row for row. Returns (x, r), r
    the MLP output not yet added."""
    x, n = add_rmsnorm_serve(p["ln1"], x, r)
    x, n = add_rmsnorm_serve(p["ln2"], x, attend(n))
    if cfg.num_experts:
        return x, moe.moe_serve(p["moe"], cfg, n)[0]
    return x, mlp_serve(p["mlp"], n)


def block_decode(p, cfg, x, r, cache, position):
    """One-token block application. x: (B, 1, d); r: the residual branch
    not yet added to x (None before the first dense block; the ssm
    family adds its own). Returns (x, r, cache), the cache written in
    place."""
    if cfg.family == "ssm":
        h, cache = rwkv6.time_mix_step(p["rwkv"], cfg,
                                       rmsnorm(p["ln1"], x)[:, 0], cache)
        x = x + h[:, None]
        h, cache = rwkv6.channel_mix(p["rwkv"], rmsnorm(p["ln2"], x)[:, 0],
                                     cache, single=True)
        return x + h[:, None], None, cache
    if cfg.family == "hybrid":
        h, cache = mamba2.mamba2_step(p["mamba"], cfg,
                                      rmsnorm(p["ln"], x)[:, 0], cache)
        return x + h[:, None], None, cache
    x, r = _serve_block(p, cfg, x, r, lambda n: attn.attention_decode(
        p["attn"], cfg, n, cache, position)[0])
    return x, r, cache


def _scan_blocks_decode(stacked, cfg, x, r, cache, position, shared_attn=None,
                        shared_cache=None):
    """Apply a stacked group of blocks to one token, layer by layer (JAX:
    ``lax.scan``), each layer's state written back into the stack; in
    the hybrid family the shared attention decodes after each of the
    first G groups of ``cfg.attn_every`` blocks, over site g's KV cache
    ``shared_cache``. Returns (x, r)."""
    if stacked is None:
        return x, r
    L = leaves(stacked)[0].shape[0]
    G = _shared_groups(cfg, L, None if shared_cache is None
                       else shared_attn)
    per = cfg.attn_every
    for i in range(L):
        layer_c = _layer(cache, i)
        x, r, new_c = block_decode(tree_map(lambda a, i=i: a[i], stacked),
                                   cfg, x, r, layer_c, position)
        for k, a in new_c.items():
            if a is not layer_c[k]:      # a recurrent state is new tensors
                cache[k][i].copy_(a)
        if i < G * per and (i + 1) % per == 0:
            h, _ = attn.attention_decode(
                shared_attn["attn"], cfg, rmsnorm(shared_attn["ln"], x),
                _layer(shared_cache, i // per), position)
            x = x + h
    return x, r


def decode_step(params, cfg, token, position, cache):
    """token: (B,) int; position: (B,) int32. Returns (logits (B, V),
    cache), the cache updated in place. The hybrid family's shared
    attention decodes in the body only, as in JAX's ``decode_step``."""
    x, r = embedding(params["embed"], token[:, None]), None
    x, r = _scan_blocks_decode(params["body"], cfg, x, r, cache["body"],
                               position, params.get("shared_attn"),
                               cache.get("shared"))
    x, r = _scan_blocks_decode(params["tail"], cfg, x, r, cache["tail"],
                               position)
    return _head(params, cfg, x, r)[:, 0], cache


def _head(params, cfg, x, r):
    """The final norm and ``lm_head`` of a serving step: on the
    row-invariant kernels for the dense family (its serving contract; the
    last block's residual r added in the norm's launch), on ``rmsnorm`` /
    ``dense`` for the ssm and hybrid families (per token only)."""
    if cfg.family in ("ssm", "hybrid"):
        return dense(params["lm_head"], rmsnorm(params["final_norm"], x))
    _, n = add_rmsnorm_serve(params["final_norm"], x, r)
    return dense_serve(params["lm_head"], n)


# ---------------------------------------------------- chunked prefill ------

def block_prefill(p, cfg, x, r, cache, positions):
    """One prompt chunk through one block. x: (B, c, d); r as in
    ``block_decode``. Attention-family blocks only (the ssm family keeps
    the per-token path); the norms and the MLP half are the decode
    path's (``_serve_block``), so the residual stream matches
    ``block_decode`` row for row. Returns (x, r, cache), the cache
    written in place."""
    x, r = _serve_block(p, cfg, x, r, lambda n: attn.attention_prefill(
        p["attn"], cfg, n, cache, positions)[0])
    return x, r, cache


def _scan_blocks_prefill(stacked, cfg, x, r, cache, positions):
    if stacked is None:
        return x, r
    for i in range(leaves(stacked)[0].shape[0]):
        x, r, _ = block_prefill(tree_map(lambda a, i=i: a[i], stacked), cfg,
                                x, r, _layer(cache, i), positions)
    return x, r


def prefill(params, cfg, tokens, positions, cache):
    """Chunked prefill: one call a prompt CHUNK instead of one a token.
    tokens/positions: (B, c); pad rows carry positions >=
    ``attention.PAD_FLOOR`` and never enter the cache. Returns (logits
    (B, c, V), cache), bit-identical to looping ``decode_step`` over the
    chunk (the projections and norms on the row-invariant kernels)."""
    x, r = embedding(params["embed"], tokens), None
    for g in ("body", "tail"):
        x, r = _scan_blocks_prefill(params[g], cfg, x, r, cache[g],
                                    positions)
    return _head(params, cfg, x, r), cache


# --------------------------------------------------------- paged cache -----

def init_paged_pool(cfg, num_blocks: int, block_size: int, dtype=None,
                    device=None) -> dict:
    """Block pool shared by all in-flight requests: per layer group
    leaves (n_layers, num_blocks, block_size, KH, hd) and pos (n_layers,
    nb, bs). Block 0 is reserved as the null/trash block (block-table
    entry 0 = unmapped)."""
    check_family(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim

    def group(n):
        if n == 0:
            return None
        kv = (n, num_blocks, block_size, cfg.num_kv_heads, hd)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "pos": torch.full((n, num_blocks, block_size), -1,
                                  dtype=torch.int32, device=device)}

    return {g: group(n) for g, n in _groups(cfg).items()}


def _scan_blocks_paged(stacked, cfg, x, r, pool, table, ring_len,
                       positions, prefill_chunk: bool):
    """The blocks of a group against the pool (``_serve_block``).
    Returns (x, r)."""
    if stacked is None:
        return x, r
    fn = attn.attention_prefill_paged if prefill_chunk \
        else attn.attention_decode_paged
    for i in range(leaves(stacked)[0].shape[0]):
        p = tree_map(lambda a, i=i: a[i], stacked)
        x, r = _serve_block(p, cfg, x, r, lambda n, p=p, i=i: fn(
            p["attn"], cfg, n, _layer(pool, i), table, ring_len,
            positions)[0])
    return x, r


def decode_step_paged(params, cfg, token, position, pool, table, ring_len):
    """One decode step against the shared block pool. token/position:
    (B,); table: (B, mb) int32 block ids (0 = unmapped); ring_len: (B,)
    int32 logical ring modulus per request. Returns (logits (B, V),
    pool), the pool updated in place."""
    x, r = embedding(params["embed"], token[:, None]), None
    for g in ("body", "tail"):
        x, r = _scan_blocks_paged(params[g], cfg, x, r, pool[g], table,
                                  ring_len, position, False)
    return _head(params, cfg, x, r)[:, 0], pool


def prefill_paged(params, cfg, tokens, positions, pool, table, ring_len):
    """Chunked prefill against the shared block pool. tokens/positions:
    (B, c). Returns (logits (B, c, V), pool), the pool updated in
    place."""
    x, r = embedding(params["embed"], tokens), None
    for g in ("body", "tail"):
        x, r = _scan_blocks_paged(params[g], cfg, x, r, pool[g], table,
                                  ring_len, positions, True)
    return _head(params, cfg, x, r), pool
