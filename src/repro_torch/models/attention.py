"""Attention: GQA + RoPE + optional sliding window, on the flash kernel.

The port of the JAX package's ``models/attention.py`` for full-sequence
attention (train): ``attn_init``, ``_split_heads`` and ``attention_fwd``
(self-attention, the encoder's non-causal attention, and
cross-attention from ``kv_x``: q of x against k, v of the encoder's
output, Sq != Skv, no RoPE). The JAX model repeats kv to the query heads
(``_repeat_kv``) and runs the XLA ``chunked_attention``; the port hands
``kernels.flash_attention`` the kv heads as they are (its kernels read
kv head h // n_rep for query head h: the same math without the copy and
without autograd's sum of the copies' gradients) and runs the
hand-written CUDA kernels on the card, their plain version on the CPU.
The tests hold the port against JAX's own ``chunked_attention``.

Serving (decode, chunked prefill, the paged KV pool): the port of
``init_kv_cache``, ``_chunk_slots``, ``attention_decode``,
``attention_prefill``, ``paged_view``, ``_paged_write``,
``attention_decode_paged`` and ``attention_prefill_paged``. Projections
and RoPE are those of ``attention_fwd``, the projections on the
row-invariant GEMM (``kernels.invariant_dense``: the same bits as
``dense`` on the CPU; on the card a row does not depend on the rows
beside it, as cuBLAS's do); the scores, mask, softmax and
weighted sum of all four entry points go through
``kernels.serve_attention`` (the hand-written CUDA kernel on the card,
its plain version on the CPU), which reads the cache as it was before the
chunk and selects each query row's ring state itself, so chunked prefill
equals the per-token loop and paged equals dense, bit for bit. The JAX
functions return new caches; the port writes the chunk's k, v and
positions into the cache or pool IN PLACE (after the kernel has read it)
and returns the same tensors, as JAX's engines donate them.
``cross_attention_decode`` (the encoder-decoder family's decoder, at
decode and at a prefill chunk alike) projects the rows' q on the
row-invariant GEMM and attends to the encoder's precomputed K/V through
``kernels.serve_attention.serve_cross_attention`` (every key visible,
nothing written), so its chunk rows too equal the per-token rows bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
# the pad sentinels of a prefill chunk (PAD_POS for the engines' pad rows)
from repro_torch.kernels.ref import PAD_FLOOR, PAD_POS  # noqa: F401
from repro_torch.kernels.serve_attention import (serve_attention,
                                                 serve_cross_attention)
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       dense_serve, dense_serve_group)


def attn_init(gen: torch.Generator, cfg, dtype) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype,
                         cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         cfg.qkv_bias),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }


def _split_heads(x, n_heads: int, hd: int):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def attention_fwd(p, cfg, x, positions, *, causal=True, kv_x=None,
                  kv_positions=None, window=None):
    """Full-sequence attention (train / prefill / encoder / cross). x:
    (B, S, d); positions: (B, S), the aligned 0..S-1 of
    ``transformer.embed_inputs`` (the kernel masks by row and column
    index, which equal those positions). ``kv_x`` (B, Skv, d), the
    source of k and v for cross-attention (x by default), with
    ``kv_positions`` (B, Skv); RoPE applies only where ``causal`` or
    ``kv_x`` is None (self-attention), as in JAX.

    q is scaled by hd**-0.5 in the model dtype before the kernel, which
    then runs with scale 1.0: the JAX model's ``chunked_attention``
    rounds ``q * scale`` in the model dtype before its f32 cast, so a
    bf16 model rounds at the same place in both packages.
    """
    hd = cfg.resolved_head_dim
    kv_src = x if kv_x is None else kv_x
    kv_pos = positions if kv_positions is None else kv_positions
    q = _split_heads(dense(p["wq"], x), cfg.num_heads, hd)
    k = _split_heads(dense(p["wk"], kv_src), cfg.num_kv_heads, hd)
    v = _split_heads(dense(p["wv"], kv_src), cfg.num_kv_heads, hd)
    if causal or kv_x is None:           # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    w = cfg.sliding_window if window is None else window
    out = flash_attention(q * hd ** -0.5, k, v, causal=causal, window=w,
                          scale=1.0)
    return dense(p["wo"], out.reshape(*x.shape[:-1], cfg.num_heads * hd))


# ------------------------------------------------------------- decoding ----

def init_kv_cache(cfg, batch: int, max_len: int, dtype, device=None) -> dict:
    """Ring-buffer cache when sliding_window > 0, else linear cache."""
    hd = cfg.resolved_head_dim
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv = (batch, L, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32,
                              device=device)}


def _qkv(p, cfg, x, positions):
    """q (pre-scaled by hd**-0.5 in the model dtype, as ``attention_fwd``
    hands it to its kernel), k, v of x (B, c, d) at ``positions`` (B, c),
    RoPE applied. The serving projections (here and in ``_out``) run on
    the row-invariant GEMM, wq, wk and wv in one launch
    (``layers.dense_serve_group``)."""
    hd = cfg.resolved_head_dim
    q, k, v = dense_serve_group((p["wq"], p["wk"], p["wv"]), x)
    q = _split_heads(q, cfg.num_heads, hd)
    k = _split_heads(k, cfg.num_kv_heads, hd)
    v = _split_heads(v, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return (q * hd ** -0.5).contiguous(), k.contiguous(), v.contiguous()


def _out(p, cfg, out):
    B, c = out.shape[:2]
    return dense_serve(p["wo"], out.reshape(B, c, -1))


def attention_decode(p, cfg, x, cache, position):
    """One-token decode. x: (B, 1, d); position: (B,) int32 absolute
    index. Returns (out (B, 1, d), cache), the cache written in place."""
    B = x.shape[0]
    pos = position.to(torch.int32)[:, None].contiguous()
    q, k, v = _qkv(p, cfg, x, pos)
    out = serve_attention(q, k, v, pos, cache["k"], cache["v"], cache["pos"],
                          window=cfg.sliding_window)
    slot = pos[:, 0].long() % cache["k"].shape[1]           # ring slot
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = pos[:, 0]
    return _out(p, cfg, out), cache


def _chunk_slots(positions, ring_len):
    """Cache slots for one prefill chunk: consecutive from the chunk's
    FIRST position (which is always real), so pad rows land on distinct
    no-op slots instead of ``PAD_POS % ring_len`` colliding with a real
    write. ``ring_len``: an int or (B, 1). Requires chunk <= ring_len
    (engine contract)."""
    c = positions.shape[1]
    ar = torch.arange(c, dtype=torch.int32, device=positions.device)
    return ((positions[:, :1] + ar) % ring_len).to(torch.int32)


def attention_prefill(p, cfg, x, cache, positions):
    """Blockwise prefill of one prompt chunk against the decode cache.

    x: (B, c, d); positions: (B, c) int32 absolute, consecutive from the
    chunk's first position; pad rows carry position >= PAD_FLOOR and
    never enter the cache (their slot's current entry is written back).
    The kernel gives every query row the ring state the per-token loop
    sees at its position, so logits and cache equal the per-token
    ``attention_decode`` loop bit for bit."""
    B, c, _ = x.shape
    positions = positions.to(torch.int32).contiguous()
    q, k, v = _qkv(p, cfg, x, positions)
    out = serve_attention(q, k, v, positions, cache["k"], cache["v"],
                          cache["pos"], window=cfg.sliding_window)
    slots = _chunk_slots(positions, cache["k"].shape[1]).long()
    bidx = torch.arange(B, device=x.device)[:, None]
    real = positions < PAD_FLOOR
    k_w = torch.where(real[..., None, None], k, cache["k"][bidx, slots])
    v_w = torch.where(real[..., None, None], v, cache["v"][bidx, slots])
    p_w = torch.where(real, positions, cache["pos"][bidx, slots])
    cache["k"][bidx, slots] = k_w
    cache["v"][bidx, slots] = v_w
    cache["pos"][bidx, slots] = p_w
    return _out(p, cfg, out), cache


def cross_attention_decode(p, cfg, x, enc_k, enc_v):
    """Cross-attention against precomputed encoder K/V (B, L, KH, hd),
    computed once at the start of decode (``encdec.init_decode_cache``).
    x: (B, c, d), c = 1 at decode, a whole prompt chunk at prefill (pad
    rows compute like any row; the caller drops them). No RoPE; q
    pre-scaled by hd**-0.5 in the model dtype, as JAX scales it; wq and
    wo on the row-invariant GEMM. Returns (B, c, d)."""
    hd = cfg.resolved_head_dim
    q = _split_heads(dense_serve(p["wq"], x), cfg.num_heads, hd)
    out = serve_cross_attention((q * hd ** -0.5).contiguous(), enc_k, enc_v)
    return _out(p, cfg, out)


# ----------------------------------------------------------- paged KV ------

def paged_view(pool, table):
    """Dense per-request view of a block pool.

    pool: {"k"/"v": (nb, bs, KH, hd), "pos": (nb, bs)}; table: (B, mb)
    int32 physical block ids per request (0 = the reserved null block).
    Returns (k, v, pos) shaped (B, mb*bs, ...): the layout of a dense
    cache of length mb*bs, unmapped slots at pos -1. The kernel reads
    through the table itself; this is the view it computes over."""
    nb, bs = pool["pos"].shape
    blk = table.long().clamp(0, nb - 1)
    B, mb = table.shape
    pos = torch.where((table > 0)[..., None], pool["pos"][blk], -1)
    return (pool["k"][blk].reshape(B, mb * bs, *pool["k"].shape[2:]),
            pool["v"][blk].reshape(B, mb * bs, *pool["v"].shape[2:]),
            pos.reshape(B, mb * bs))


def _paged_phys(pool, table, slots):
    """(physical block, offset) of logical ring slots (B, c)."""
    nb, bs = pool["pos"].shape
    phys = torch.gather(table.long(), 1, slots // bs).clamp(0, nb - 1)
    return phys, slots % bs


def _paged_write(pool, table, slots, k, v, pos):
    """Scatter per-request logical ring slots into the pool, in place.

    slots: (B, c) logical slots; k/v: (B, c, KH, hd); pos: (B, c).
    Requests own disjoint blocks, so cross-request writes never collide;
    slots within a request's chunk are distinct by the _chunk_slots
    contract. Rows whose table entry is 0 land in the null block."""
    phys, off = _paged_phys(pool, table, slots.long())
    pool["k"][phys, off] = k
    pool["v"][phys, off] = v
    pool["pos"][phys, off] = pos
    return pool


def attention_decode_paged(p, cfg, x, pool, table, ring_len, position):
    """One-token decode against the shared block pool.

    x: (B, 1, d); table: (B, mb) int32; ring_len: (B,) int32 per-request
    logical ring modulus (min(max_len, window) for SWA, the request's
    max_len otherwise); position: (B,) absolute. The math of
    ``attention_decode`` over the pool's view, bit for bit."""
    pos = position.to(torch.int32)[:, None].contiguous()
    q, k, v = _qkv(p, cfg, x, pos)
    out = serve_attention(q, k, v, pos, pool["k"], pool["v"], pool["pos"],
                          table, ring_len, window=cfg.sliding_window)
    _paged_write(pool, table, pos % ring_len[:, None], k, v, pos)
    return _out(p, cfg, out), pool


def attention_prefill_paged(p, cfg, x, pool, table, ring_len, positions):
    """Blockwise prefill of one prompt chunk into the shared block pool:
    ``attention_prefill`` with the cache axes behind a block table. The
    same pad sentinel and ring selection; requires chunk <=
    min(ring_len)."""
    positions = positions.to(torch.int32).contiguous()
    q, k, v = _qkv(p, cfg, x, positions)
    out = serve_attention(q, k, v, positions, pool["k"], pool["v"],
                          pool["pos"], table, ring_len,
                          window=cfg.sliding_window)
    slots = _chunk_slots(positions, ring_len[:, None]).long()
    phys, off = _paged_phys(pool, table, slots)
    real = positions < PAD_FLOOR
    k_w = torch.where(real[..., None, None], k, pool["k"][phys, off])
    v_w = torch.where(real[..., None, None], v, pool["v"][phys, off])
    p_w = torch.where(real, positions, pool["pos"][phys, off])
    _paged_write(pool, table, slots, k_w, v_w, p_w)
    return _out(p, cfg, out), pool
