"""Plain PyTorch versions of the port's kernels: the server plane,
``ama_mix``, flash attention, the serving kernels and the RWKV-6 and
Mamba-2 recurrences.

The counterparts of the JAX package's ``kernels/ref.py: _norm_weights,
server_mix_math, server_mix_delta_math, server_mix_scatter_math,
server_async_math, server_adam_math`` (and, for ``ama_mix_math`` and its
leaf-by-leaf ``ama_mix_leaves_math``, of the Pallas body of
``kernels/ama_mix.py``), in the same op order: the
previous model scaled first, then one multiply-add per client row in
client order (and, for the async plane, one chain per ring slot, then
the pop sum from slot 0 upward). Every multiply and add rounds on its
own, as PyTorch's eager ops do, and the CUDA kernels in ``csrc/*.cu``
do the same (no fused multiply-add), so on the card a kernel and its
plain version agree to within the few ulp that library ``exp`` may
differ by. Where JAX sums the weights with ``jnp.sum``, these sum them
one add at a time from client 0 (``_seq_sum``), as the kernels do.

``flash_attention_ref`` is the math of the JAX package's
``kernels/ref.py: flash_attention_ref`` (plain masked softmax attention
in f32), returning the log-sum-exp rows as well; ``flash_attention_bwd_ref``
is its gradient by the explicit formula the backward kernels compute
(``D = rowsum(dO * O)``, ``dS = P * (dP - D)``).

``serve_attention_ref`` is the serving attention of the JAX package's
``models/attention.py`` (decode and chunked prefill, over a dense ring
cache or a paged pool, with the ring selection of a prefill chunk that
wraps the window): one query row at a time, every sum a sequential scan
(``cumsum``) in slot order, so no result depends on the chunk width,
the batch or the cache's length.

``invariant_dense_ref``, ``invariant_rmsnorm_ref`` and
``invariant_add_rmsnorm_ref`` are the serving steps' projection, RMSNorm
and residual add + RMSNorm as the JAX package's ``models/layers.py:
dense, rmsnorm`` compute them (``x @ w + b``; the mean of squares in f32):
on the CPU the row-invariant kernels' wrappers run exactly these, so the
serving path keeps the bits of ``layers.dense`` / ``layers.rmsnorm``.

``rwkv6_scan_ref`` is the RWKV-6 recurrence of the JAX package's
``kernels/ref.py: rwkv6_scan_ref``, a loop over time, returning the
states it saves every ``RWKV6_CKPT`` steps as well;
``rwkv6_scan_bwd_ref`` is its gradient by the explicit adjoint
recurrence the backward kernel computes, recomputing each segment's
states from the saved ones.

``mamba2_scan_ref`` is the Mamba-2 (SSD) state recurrence of the JAX
package's ``models/mamba2.py: mamba2_fwd`` (the ``step`` of its
``lax.scan``), a loop over time, returning the states it saves every
``MAMBA2_CKPT`` steps as well; ``mamba2_scan_bwd_ref`` is its gradient
by the adjoint recurrence the backward kernel computes, recomputing each
segment's states from the saved ones.

The wrappers in ``server_plane.py``, ``ama_mix.py``,
``flash_attention.py``, ``serve_attention.py``, ``invariant_dense.py``,
``invariant_rmsnorm.py``, ``rwkv6_scan.py`` and ``mamba2_scan.py``
run these for CPU
tensors; on the card the server-plane ones run only when
``fl.server_plane == "ref"``.
"""
from __future__ import annotations

import torch

# Eq. 9's alpha^- = 1 - sigmoid(1), rounded to f32 exactly as the JAX
# package computes it; the CUDA kernel carries the same literal.
ALPHA_UNNORM = float.fromhex("0x1.13656p-2")


def _seq_sum(v):
    """Sum over the leading axis, one add at a time from row 0."""
    acc = v[0]
    for k in range(1, v.shape[0]):
        acc = acc + v[k]
    return acc


def ama_mix_math(prev, stacked, alpha, weights):
    """alpha * prev + sum_k weights[k] * stacked[k], accumulated in f32
    one client row at a time (the Pallas body's order, not the JAX
    oracle's einsum), output in prev's dtype.

    prev: (n,) f32/bf16; stacked: (K, n) f32/bf16; alpha: (1,) f32;
    weights: (K,) f32.
    """
    acc = prev.float() * alpha[0]
    for k in range(stacked.shape[0]):
        acc = acc + stacked[k].float() * weights[k]
    return acc.to(prev.dtype)


def ama_mix_leaves_math(prevs, stackeds, alpha, weights):
    """``ama_mix_math`` leaf by leaf: prevs a list of (n_j,) f32/bf16,
    stackeds the matching (K, n_j) f32/bf16; alpha: (1,) f32; weights:
    (K,) f32. Returns the list of outputs."""
    return [ama_mix_math(p, s, alpha, weights)
            for p, s in zip(prevs, stackeds, strict=True)]


def _norm_weights(sizes, keep):
    """w_i = |d_i|*keep_i / sum_j |d_j|*keep_j (the FedAvg convention);
    ``keep`` is a {0,1} f32 mask. Returns (w, tot)."""
    w = sizes.float() * keep.float()
    tot = _seq_sum(w)
    return w / torch.clamp(tot, min=1e-9), tot


def server_mix_math(prev, stacked, sizes, keep, coefs):
    """The sync server plane: participation weights + weighted client
    accumulation + AMA mix.

    prev: (n,) f32/bf16; stacked: (K, n) in prev's dtype; sizes/keep:
    (K,) f32; coefs: (4,) f32 = [alpha0, eta, alpha_cap, t]. alpha_t =
    min(alpha0 + eta*t, cap); fedavg passes zeros for a plain weighted
    average. When nobody is kept (tot == 0) the whole beta budget
    reverts to the previous model.
    """
    alpha = torch.minimum(coefs[0] + coefs[1] * coefs[3], coefs[2])
    beta = 1.0 - alpha
    w, tot = _norm_weights(sizes, keep)
    a_eff = torch.where(tot > 0, alpha, alpha + beta)
    acc = prev.float() * a_eff
    for k in range(stacked.shape[0]):
        acc = acc + stacked[k].float() * (beta * w[k])
    return acc.to(prev.dtype)


def _compressed_coefs(sizes, keep, coefs):
    """(beta * w, prev's coefficient a_eff + beta * sum_k w_k) of the
    mix over compressed deltas. a_eff is 1 when nobody is kept, so the
    previous model comes back unchanged."""
    alpha = torch.minimum(coefs[0] + coefs[1] * coefs[3], coefs[2])
    beta = 1.0 - alpha
    w, tot = _norm_weights(sizes, keep)
    a_eff = torch.where(tot > 0, alpha, 1.0)
    return beta * w, a_eff + beta * _seq_sum(w)


def server_mix_delta_math(prev, dstacked, rowscale, sizes, keep, coefs):
    """The sync server plane over compressed client deltas: row k of
    ``dstacked`` is client k's delta x_k - prev, quantized (int8 or
    bf16; ``rowscale[k]`` de-quantizes it):

        out = prev * (a_eff + beta * sum_k w_k)
              + sum_k (beta * w_k * rowscale[k]) * d_k

    prev: (n,) f32/bf16; dstacked: (K, n) int8/bf16/f32; rowscale/
    sizes/keep: (K,) f32; coefs: (4,) f32 = [alpha0, eta, alpha_cap, t].
    """
    bw, c = _compressed_coefs(sizes, keep, coefs)
    acc = prev.float() * c
    for k in range(dstacked.shape[0]):
        acc = acc + dstacked[k].float() * (bw[k] * rowscale[k])
    return acc.to(prev.dtype)


def server_mix_scatter_math(prev, vals, idx, sizes, keep, coefs):
    """The sync server plane over top-k sparsified client deltas: row k
    keeps its kk largest-magnitude delta entries as (value, flat
    position) pairs, added into the mix of prev client by client.

    prev: (n,) f32/bf16; vals: (K, kk) f32; idx: (K, kk) int32 flat
    positions, distinct within a row; sizes/keep: (K,) f32; coefs: (4,)
    f32. A position outside [0, n) adds nothing (the JAX oracle's mask).
    Positions are distinct within a row, so each ``index_add_`` adds at
    most once per element and the sum runs in client order.
    """
    n = prev.shape[0]
    bw, c = _compressed_coefs(sizes, keep, coefs)
    acc = prev.float() * c
    for k in range(vals.shape[0]):
        inside = (idx[k] >= 0) & (idx[k] < n)
        contrib = vals[k].float() * bw[k] * inside.float()
        acc.index_add_(0, torch.clamp(idx[k], 0, n - 1).long(), contrib)
    return acc.to(prev.dtype)


def server_adam_math(prev, stacked, m, v, sizes, keep, scalars):
    """The FedOpt server plane: weighted pseudo-gradient, one server-Adam
    moment update and the model step.

    prev: (n,) f32/bf16; stacked: (K, n) in prev's dtype; m/v: (n,) f32;
    sizes/keep: (K,) f32; scalars: (5,) f32 = [b1, b2, lr, tau, step]
    (step already incremented). The pseudo-gradient is 0 when nobody is
    kept. Returns (out in prev's dtype, new_m, new_v).
    """
    b1, b2, lr, tau, step = (scalars[i] for i in range(5))
    w, tot = _norm_weights(sizes, keep)
    agg = torch.zeros(prev.shape, dtype=torch.float32, device=prev.device)
    for k in range(stacked.shape[0]):
        agg = agg + stacked[k].float() * w[k]
    p32 = prev.float()
    delta = torch.where(tot > 0, agg - p32, 0.0)
    new_m = b1 * m + (1.0 - b1) * delta
    new_v = b2 * v + (1.0 - b2) * delta * delta
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    update = (new_m / bc1) / (torch.sqrt(new_v / bc2) + tau)
    return (p32 + lr * update).to(prev.dtype), new_m, new_v


def server_async_math(prev, stacked, qsum, qgamma, sizes, delayed, delays,
                      tq, hyp):
    """The async server plane (paper Eqs. 6-11): staleness weights
    gamma^- from ``delays``, ring-buffer enqueue of this round's delayed
    updates, pop of the slot arriving now, and the alpha/beta/gamma mix.

    prev: (n,); stacked: (K, n); qsum: (Q, n) f32; qgamma: (Q,) f32;
    sizes/delayed: (K,) f32; delays: (K,) int32; tq: (2,) int32 =
    [t, t % Q]; hyp: (4,) f32 = [alpha0, eta, alpha_cap, staleness_b].
    Returns (out, new_qsum, new_qgamma).
    """
    K, Q = stacked.shape[0], qgamma.shape[0]
    t, pop = tq[0], tq[1]
    # gamma^- = b * sigmoid(-d), never b * (1 - sigmoid(d)): the latter
    # cancels catastrophically in f32 for stale updates
    g = hyp[3] * torch.sigmoid(-delays.float()) * delayed.float()
    arrival = torch.remainder(t + delays, Q)                      # (K,)
    slots = torch.arange(Q, device=prev.device)
    onehot = (arrival[:, None] == slots[None, :]).float() * g[:, None]
    qg = qgamma + _seq_sum(onehot)
    sel = (slots == pop).float()                                  # pop mask
    stale_gamma = _seq_sum(qg * sel)
    new_qgamma = qg * (1.0 - sel)

    A = torch.minimum(hyp[0] + hyp[1] * t.float(), hyp[2])
    beta = 1.0 - A
    denom = ALPHA_UNNORM + stale_gamma
    # a true division (a Python number over a tensor would be computed
    # as reciprocal-then-multiply, which rounds differently)
    alpha = torch.full_like(denom, ALPHA_UNNORM) / denom * A      # Eq. 10
    gscale = A / denom                                            # Eq. 11
    w, tot = _norm_weights(sizes, 1.0 - delayed.float())
    a_eff = torch.where(tot > 0, alpha, alpha + beta)

    acc = prev.float() * a_eff
    rows = [qsum[q] for q in range(Q)]
    for k in range(K):
        x = stacked[k].float()
        acc = acc + x * (beta * w[k])
        for q in range(Q):                  # enqueue into arrival slots
            rows[q] = rows[q] + x * onehot[k, q]
    stale = rows[0] * sel[0]                # pop slot t % Q
    for q in range(1, Q):
        stale = stale + rows[q] * sel[q]
    acc = acc + stale * gscale
    new_qsum = torch.stack([rows[q] * (1.0 - sel[q]) for q in range(Q)])
    return acc.to(prev.dtype), new_qsum, new_qgamma


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

#: the masked-score sentinel of the JAX package's attention code
NEG_INF = -1e30


def attention_mask(S: int, causal: bool, window: int, device,
                   Skv: int | None = None):
    """(S, Skv) bool (Skv defaults to S), True where query row i may
    attend to key j: j <= i when causal, j > i - window when windowed
    (the Pallas kernel's masks); every pair when neither (the
    cross-attention of S queries against Skv keys)."""
    Skv = S if Skv is None else Skv
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def _repeat_kv(x, H):
    """kv (B, S, Hkv, hd) repeated to H heads: query head h reads kv head
    h // (H // Hkv), as the kernels index it."""
    Hkv = x.shape[2]
    return x if Hkv == H else torch.repeat_interleave(x, H // Hkv, dim=2)


def _sum_groups(g, Hkv):
    """A gradient (B, Skv, H, hd) f32 of repeated kv summed back to Hkv
    heads."""
    B, S, H, hd = g.shape
    return g if Hkv == H else g.reshape(B, S, Hkv, H // Hkv, hd).sum(3)


def _scores(q, k, causal, window, scale):
    """Masked f32 scores (B, H, Sq, Skv) and the mask; k at q's heads."""
    Sq, Skv, hd = q.shape[1], k.shape[1], q.shape[-1]
    if Sq != Skv and (causal or window):
        raise ValueError(f"q of {Sq} rows against k, v of {Skv} "
                         "(cross-attention) takes no causal mask and no "
                         "window")
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(Sq, causal, window, q.device, Skv)
    return torch.where(mask, s, NEG_INF), mask, scale


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Plain softmax attention. q: (B, Sq, H, hd), k/v: (B, Skv, Hkv,
    hd), H a multiple of Hkv (kv repeated here to H heads; Hkv == H is
    the TPU kernel's head-repeated contract), Sq != Skv only without a
    causal mask or a window; ``scale=None`` is hd**-0.5. Returns (out
    (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32, the log-sum-exp of
    each row's scaled, masked scores)."""
    H = q.shape[2]
    s, _, _ = _scores(q, _repeat_kv(k, H), causal, window, scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(v, H).float())
    return out.to(q.dtype).contiguous(), torch.logsumexp(s, dim=-1)


def flash_bwd_dq_ref(dout, q, k, v, out, lse, *, causal=True, window=0,
                     scale=None):
    """The plain version of the ``flash_bwd_dq`` kernel: D = rowsum(dO *
    O) (B, H, Sq) f32 and dQ = scale * dS K with P = exp(s - lse), dP =
    dO V^T, dS = P * (dP - D); k/v at Hkv heads as in
    ``flash_attention_ref``. Returns (dq in q's dtype, D)."""
    H = q.shape[2]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    s, mask, scale = _scores(q, k, causal, window, scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    do = dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype).contiguous(), delta.contiguous()


def flash_bwd_dkdv_ref(dout, q, k, v, lse, delta, *, causal=True, window=0,
                       scale=None):
    """The plain version of the ``flash_bwd_dkdv`` kernel, given D from
    the dQ pass: dV = P^T dO and dK = scale * dS^T Q, at H heads, then
    summed in f32 over the query heads of each kv head. Returns (dk, dv)
    (B, Skv, Hkv, hd) in the dtypes of k and v."""
    H, Hkv = q.shape[2], k.shape[2]
    s, mask, scale = _scores(q, _repeat_kv(k, H), causal, window, scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, _repeat_kv(v, H).float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return (_sum_groups(dk, Hkv).to(k.dtype).contiguous(),
            _sum_groups(dv, Hkv).to(v.dtype).contiguous())


def flash_attention_bwd_ref(dout, q, k, v, out, lse, *, causal=True,
                            window=0, scale=None):
    """The gradient of ``flash_attention_ref``'s output by the explicit
    formula, in f32: P = exp(s - lse), D = rowsum(dO * O), dV = P^T dO,
    dP = dO V^T, dS = P * (dP - D), dQ = scale * dS K, dK = scale * dS^T
    Q (dK, dV summed over each kv head's query heads). Returns (dq, dk,
    dv) in the dtypes and shapes of q, k, v."""
    kw = dict(causal=causal, window=window, scale=scale)
    dq, delta = flash_bwd_dq_ref(dout, q, k, v, out, lse, **kw)
    dk, dv = flash_bwd_dkdv_ref(dout, q, k, v, lse, delta, **kw)
    return dq, dk, dv


# --------------------------------------------------------------------------
# serving attention
# --------------------------------------------------------------------------

#: pad sentinel on the position axis of a prefill chunk: rows at or above
#: PAD_FLOOR are padding (they never enter the cache; their outputs are
#: garbage the caller drops). The JAX package's ``models/attention.py``.
PAD_FLOOR = 2 ** 29
PAD_POS = 2 ** 30


def _last_of_scan(x, dim):
    """The sum of ``x`` along ``dim`` as a sequential scan in index order
    (the last element of ``cumsum``): its rounding depends only on the
    summed values and their order, never on the other axes' sizes or on
    how many zeros follow, which ``torch.sum``'s vectorised reduction does
    not promise."""
    return torch.cumsum(x, dim).select(dim, -1)


def serve_chunk_sources(positions, ring_len, table, n_slots: int, bs: int):
    """For each logical cache slot (B, n_slots): the chunk row j that
    writes it, or c when none does. Chunk row j writes logical slot
    (positions[:, 0] + j) % ring_len (``_chunk_slots``: consecutive from
    the chunk's first position) when it is real (position < PAD_FLOOR);
    a slot at or past the ring, or whose block is unmapped (table entry 0
    of a paged pool, ``table`` not None), is never written."""
    B, c = positions.shape
    dev = positions.device
    s = torch.arange(n_slots, device=dev)[None, :]
    R = ring_len.long()[:, None]
    j = torch.remainder(s - positions[:, :1].long(), R)
    real = torch.gather(positions < PAD_FLOOR, 1, j.clamp(max=c - 1))
    written = (s < R) & (j < c) & real
    if table is not None:
        written &= (table > 0).repeat_interleave(bs, dim=1)
    return torch.where(written, j, c)


def serve_attention_ref(q, k, v, positions, cache_k, cache_v, cache_pos,
                        table=None, ring_len=None, *, window=0):
    """The plain version of the ``serve_attention`` kernel.

    q: (B, c, H, hd), pre-scaled by hd**-0.5, and the chunk's new k, v:
    (B, c, KH, hd), H a multiple of KH (query head h reads kv head
    h // (H // KH)); positions: (B, c) int32, absolute, consecutive from
    the first (which is real), pad rows >= PAD_FLOOR. The cache BEFORE the
    chunk's write: cache_k/cache_v (NB, bs, KH, hd), cache_pos (NB, bs)
    int32 (-1 = empty), read through ``table`` (B, mb) int32 block ids of
    a paged pool (0 = the null block: its slots read as empty) with
    ``ring_len`` (B,) the logical ring modulus of each row; with ``table``
    None the cache is dense, row b the one block b of bs = L slots and
    the ring L (``init_kv_cache``'s linear or ring cache).

    Query row i sees logical slot s as chunk row j's k, v and position
    when j <= i writes s, else as the slot's old contents: exactly the
    ring state the per-token decode loop sees at position_i (JAX's
    ``written`` / ``pos_eff`` selection; for a linear cache the same as
    writing the whole chunk first). Scores q.k in f32, masked to NEG_INF
    where pos < 0, pos > position_i or (window > 0) pos <= position_i -
    window; softmax over the slots; sum of a.v in f32, cast to q's dtype.
    Returns (B, c, H, hd)."""
    B, c, H, hd = q.shape
    KH = k.shape[2]
    nb, bs = cache_pos.shape
    if table is None:
        table_ = torch.arange(B, device=q.device)[:, None]
        ring_len = torch.full((B,), bs, dtype=torch.int32, device=q.device)
    else:
        table_ = table.long().clamp(0, nb - 1)
    n_slots = table_.shape[1] * bs
    old_k = cache_k[table_].reshape(B, n_slots, KH, hd)
    old_v = cache_v[table_].reshape(B, n_slots, KH, hd)
    old_pos = cache_pos[table_].reshape(B, n_slots).long()
    if table is not None:
        mapped = (table > 0).repeat_interleave(bs, dim=1)
        old_pos = torch.where(mapped, old_pos, -1)
    src = serve_chunk_sources(positions, ring_len, table, n_slots, bs)
    j = src.clamp(max=c - 1)
    bidx = torch.arange(B, device=q.device)[:, None]
    new_k, new_v = k[bidx, j], v[bidx, j]                # (B, n_slots, KH, hd)
    new_pos = torch.gather(positions.long(), 1, j)
    out = []
    for i in range(c):
        w = src <= i                                     # (B, n_slots)
        pos = torch.where(w, new_pos, old_pos)
        ki = torch.where(w[..., None, None], new_k, old_k).float()
        vi = torch.where(w[..., None, None], new_v, old_v).float()
        qi = q[:, i].float().reshape(B, 1, KH, H // KH, hd)
        s = _last_of_scan(qi * ki[:, :, :, None, :], -1)  # (B, n, KH, rep)
        p_i = positions[:, i:i + 1].long()
        mask = (pos >= 0) & (pos <= p_i)
        if window:
            mask &= pos > p_i - window
        s = torch.where(mask[..., None, None], s, NEG_INF)
        p = torch.exp(s - s.amax(1, keepdim=True))
        l = _last_of_scan(p, 1)                          # (B, KH, rep)
        acc = _last_of_scan(p[..., None] * vi[:, :, :, None, :], 1)
        out.append((acc / l[..., None]).reshape(B, H, hd))
    return torch.stack(out, 1).to(q.dtype)


def serve_cross_attention_ref(q, enc_k, enc_v):
    """The plain version of the ``serve_cross_attention`` kernel (the
    JAX package's ``cross_attention_decode`` after its projection):
    q (B, c, H, hd), pre-scaled by hd**-0.5, against a fixed K/V
    (B, L, KH, hd), H a multiple of KH (query head h reads kv head
    h // (H // KH)); every key is visible to every row, no cache is read
    or written. Scores q.k in f32, softmax over the L keys, sum of a.v in
    f32, cast to q's dtype, each query row on its own and every sum a
    sequential scan (``_last_of_scan``), as ``serve_attention_ref``
    does: a row of a c-row chunk equals that row at c = 1 bit for bit.
    Returns (B, c, H, hd)."""
    B, c, H, hd = q.shape
    KH = enc_k.shape[2]
    k, v = enc_k.float(), enc_v.float()
    out = []
    for i in range(c):
        qi = q[:, i].float().reshape(B, 1, KH, H // KH, hd)
        s = _last_of_scan(qi * k[:, :, :, None, :], -1)   # (B, L, KH, rep)
        p = torch.exp(s - s.amax(1, keepdim=True))
        l = _last_of_scan(p, 1)                          # (B, KH, rep)
        acc = _last_of_scan(p[..., None] * v[:, :, :, None, :], 1)
        out.append((acc / l[..., None]).reshape(B, H, hd))
    return torch.stack(out, 1).to(q.dtype)


# --------------------------------------------------------------------------
# the serving steps' row-invariant projection and RMSNorm
# --------------------------------------------------------------------------

def invariant_dense_ref(x, w, b=None):
    """The plain version of the ``invariant_dense`` kernel: ``x @ w``
    (+ ``b``) as ``layers.dense`` computes it. x: (..., K); w: (K, N) in
    the JAX layout; b: (N,) or None. Returns (..., N) in x's dtype."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def invariant_rmsnorm_ref(x, g, eps: float = 1e-6):
    """The plain version of the ``invariant_rmsnorm`` kernel:
    ``layers.rmsnorm`` (the mean of squares over the last axis in f32,
    times its rsqrt, times g in f32, cast back to x's dtype)."""
    return _rmsnorm(x, g, eps)


def invariant_add_rmsnorm_ref(x, h, g, eps: float = 1e-6):
    """The plain version of the ``invariant_add_rmsnorm`` kernel: ``(s,
    layers.rmsnorm(s))`` for s = x + h."""
    s = x + h
    return s, _rmsnorm(s, g, eps)


def _rmsnorm(x, g, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * g.float()).to(x.dtype)


# --------------------------------------------------------------------------
# RWKV-6 recurrence
# --------------------------------------------------------------------------

#: steps between the states the forward saves for the backward (the CUDA
#: source's kCk)
RWKV6_CKPT = 16


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """RWKV-6 recurrence, one step at a time: y_t = r_t (S + diag(u)
    k_t^T v_t), then S <- diag(w_t) S + k_t^T v_t, per (batch, head).

    r/k/v/w: (B, S, H, hd) f32 (w in (0, 1)); u: (B, H, hd) f32, one row
    per batch row; s0: (B, H, hd, hd) f32. Returns (y
    (B, S, H, hd) f32, s_final (B, H, hd, hd) f32, states (B, H,
    ceil(S / RWKV6_CKPT), hd, hd) f32: the state entering every
    RWKV6_CKPT-th step, s0 first), the states being what the backward
    restarts from."""
    S = r.shape[1]
    uu = u[..., None]
    St = s0
    ys, states = [], []
    for t in range(S):
        if t % RWKV6_CKPT == 0:
            states.append(St)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], St + uu * kv))
        St = w[:, t, :, :, None] * St + kv
    return torch.stack(ys, 1), St, torch.stack(states, 2)


def rwkv6_scan_bwd_ref(dy, ds, r, k, v, w, u, states):
    """The gradient of ``rwkv6_scan_ref``'s (y, s_final) by the adjoint
    recurrence. dy: (B, S, H, hd) f32; ds: (B, H, hd, hd) f32, the
    gradient of s_final; states: the forward's saved states. Walking
    time backward with G the adjoint of the state after step t:

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t
        dk_t = r_t * u * (dy_t . v_t) + G v_t
        dv_t = (sum_i r_t,i u_i k_t,i) dy_t + G^T k_t
        dw_t = rowsum(G * S_{t-1})
        du  += r_t * k_t * (dy_t . v_t)
        G   <- diag(w_t) G + r_t^T dy_t

    S_{t-1} is recomputed forward from the saved state of its segment
    (never by dividing by w, which reaches 1e-24). Returns (dr, dk, dv,
    dw, du (B, H, hd), ds0), f32."""
    S = r.shape[1]
    G = ds
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for g in reversed(range(states.shape[2])):
        t0 = g * RWKV6_CKPT
        St, prev = states[:, :, g], []
        for t in range(t0, min(t0 + RWKV6_CKPT, S)):
            prev.append(St)
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            St = w[:, t, :, :, None] * St + kv
        for t in reversed(range(t0, t0 + len(prev))):
            Sp = prev[t - t0]
            r_t, k_t, v_t, w_t, dy_t = (x[:, t] for x in (r, k, v, w, dy))
            dyv = (dy_t * v_t).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", Sp, dy_t) + u * k_t * dyv
            dk[:, t] = r_t * u * dyv + torch.einsum("bhij,bhj->bhi", G, v_t)
            dv[:, t] = ((r_t * u * k_t).sum(-1, keepdim=True) * dy_t
                        + torch.einsum("bhij,bhi->bhj", G, k_t))
            dw[:, t] = (G * Sp).sum(-1)
            du = du + r_t * k_t * dyv
            G = w_t[..., :, None] * G + r_t[..., :, None] * dy_t[..., None, :]
    return dr, dk, dv, dw, du, G


# ---------------------------------------------------------------- mamba2 ----

#: the forward saves the state entering every MAMBA2_CKPT-th step (the
#: JAX scan's chunk of 64), which the backward restarts from
MAMBA2_CKPT = 64


def _mamba2_step(h, a_t, x_t, B_t):
    """h_t = a_t h_{t-1} + x_t (outer) B_t, in the op order of the JAX
    ``step``. h: (B, H, P, N); a_t: (B, H); x_t: (B, H, P); B_t: (B, N)."""
    return a_t[..., None, None] * h + x_t[..., :, None] * B_t[:, None, None, :]


def mamba2_scan_ref(a, xdt, Bm, Cm, h0):
    """Mamba-2 (SSD) recurrence, one step at a time, per (batch, head):
    h_t = a_t h_{t-1} + x_t (outer) B_t, y_t = h_t C_t.

    a: (B, S, H) f32 (the decay, in [0, 1]); xdt: (B, S, H, P) f32 (the
    dt-scaled input); Bm, Cm: (B, S, N) f32, shared by the heads; h0: (B,
    H, P, N) f32. Returns (y (B, S, H, P) f32, h_final (B, H, P, N) f32,
    states (B, H, ceil(S / MAMBA2_CKPT), P, N) f32: the state entering
    every MAMBA2_CKPT-th step, h0 first), the states being what the
    backward restarts from."""
    S = a.shape[1]
    h = h0
    ys, states = [], []
    for t in range(S):
        if t % MAMBA2_CKPT == 0:
            states.append(h)
        h = _mamba2_step(h, a[:, t], xdt[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h, torch.stack(states, 2)


def mamba2_scan_bwd_ref(dy, dh, a, xdt, Bm, Cm, states):
    """The gradient of ``mamba2_scan_ref``'s (y, h_final) by the adjoint
    recurrence. dy: (B, S, H, P) f32; dh: (B, H, P, N) f32, the gradient
    of h_final; states: the forward's saved states. Walking time
    backward with G the adjoint of h_t (dh for the last step):

        G    += dy_t (outer) C_t
        dC_t  = sum_{h,p} h_t dy_t          dxdt_t = G B_t
        dB_t  = sum_{h,p} G x_t             da_t   = sum_{p,n} G * h_{t-1}
        G    <- a_t G                       (and dh0 = G at the end)

    h_{t-1} is recomputed forward from the saved state of its segment
    (never by dividing by a_t, which underflows to 0). Returns (da, dxdt,
    dB, dC, dh0), f32, shaped as a, xdt, Bm, Cm and h0."""
    S = a.shape[1]
    G = dh
    da, dxdt, dB, dC = (torch.empty_like(x) for x in (a, xdt, Bm, Cm))
    for g in reversed(range(states.shape[2])):
        t0 = g * MAMBA2_CKPT
        h, prev = states[:, :, g], []
        for t in range(t0, min(t0 + MAMBA2_CKPT, S)):
            prev.append(h)
            h = _mamba2_step(h, a[:, t], xdt[:, t], Bm[:, t])
        for t in reversed(range(t0, t0 + len(prev))):
            hp = prev[t - t0]
            h_t = _mamba2_step(hp, a[:, t], xdt[:, t], Bm[:, t])
            G = G + dy[:, t, :, :, None] * Cm[:, t, None, None, :]
            dC[:, t] = torch.einsum("bhpn,bhp->bn", h_t, dy[:, t])
            dxdt[:, t] = torch.einsum("bhpn,bn->bhp", G, Bm[:, t])
            dB[:, t] = torch.einsum("bhpn,bhp->bn", G, xdt[:, t])
            da[:, t] = (G * hp).sum((-2, -1))
            G = a[:, t, :, None, None] * G
    return da, dxdt, dB, dC, G
