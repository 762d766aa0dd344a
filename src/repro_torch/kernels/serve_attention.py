"""Serving attention: decode and chunked prefill over a dense ring cache
or a paged block pool, on one hand-written CUDA kernel.

Replaces no Pallas kernel: the JAX package computes this with XLA
einsums in ``models/attention.py`` (``attention_decode`` :166,
``attention_prefill`` :238, ``attention_decode_paged`` :354,
``attention_prefill_paged`` :389), repeating kv to the query heads in
f32 and, for a prefill chunk over a ring, building a (B, c, L, H, hd)
copy of V. The kernel (CUDA C++ for ``sm_90a``,
``csrc/serve_attention.cu``) reads the cache in the model dtype through
the block table, reads kv head h // n_rep for query head h, and selects
each query row's ring state as it goes. The logical ring is split over
blocks in spans of SPAN slots (by slot index alone), every query row of
a kv head (up to 64) shares a block's K/V tiles, bf16 scores run on the
tensor cores and P.V on the CUDA cores in slot order, and the last
block of a row group to arrive folds the spans' partials in span order
(one launch; f32 scratch and integer counters from this wrapper). Every
output is reduced in an order fixed by the slot index and hd alone, so
a row of a c-row chunk equals that row computed at c = 1 bit for bit,
and a paged pool equals the dense cache it maps.

``serve_attention(q, k, v, positions, cache_k, cache_v, cache_pos,
table=None, ring_len=None, *, window=0)``: see
``ref.serve_attention_ref`` for the semantics. The cache is read as it
was before the chunk: the caller writes the chunk's k, v and positions
afterwards (``models/attention.py``).
``serve_cross_attention(q, enc_k, enc_v)`` is the cross form (the
encoder-decoder family's decoder; JAX's ``cross_attention_decode``,
``models/attention.py:200``, after its projection): the same kernel
with a flag, the query rows against a fixed K/V (B, L, KH, hd) with
every key visible, nothing merged in and nothing written, in the same
reduction order (a row of a c-row chunk equals that row at c = 1 bit
for bit); see ``ref.serve_cross_attention_ref``.

Dispatch is by device: a CPU tensor takes the plain version
(``ref.serve_attention_ref``, the same signature); a CUDA tensor
launches the kernel, or the wrapper raises. Each wrapper counts its
launches (``serve_attention.launches``,
``serve_cross_attention.launches``).
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check, _counters,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["serve_attention", "serve_cross_attention", "KERNELS",
           "reset_counts", "HEAD_DIMS"]

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (32, 64, 96, 128)
#: slots a span: the kernel's unit of the split over blocks, cut by
#: logical slot index alone (csrc/serve_attention.cu: kSpan)
SPAN = 256
#: warps a block (csrc/serve_attention.cu: kWarps); a warp owns one query
#: row when a kv head has at most this many (c x n_rep), else 8 (blocks of
#: 64 rows)
WARPS = 8

_I32 = (torch.int32,)

#: id(ring_len) -> (a weak reference to it, its version, its min and
#: max): the engines hand every layer of a step the same ring tensor, so
#: its device-to-host read happens once a step, not once a layer
_RING_RANGE: dict[int, tuple] = {}


def _ring_range(ring_len) -> tuple[int, int]:
    key = id(ring_len)
    hit = _RING_RANGE.get(key)
    if hit is not None and hit[0]() is ring_len and \
            hit[1] == ring_len._version:
        return hit[2]
    lo_hi = tuple(int(x) for x in torch.aminmax(ring_len))
    _RING_RANGE[key] = (weakref.ref(ring_len, lambda _, k=key:
                                    _RING_RANGE.pop(k, None)),
                        ring_len._version, lo_hi)
    return lo_hi


def _geometry(q, k, v, positions, cache_k, cache_v, cache_pos, table,
              ring_len):
    """(B, c, H, KH, hd, NB, bs, mb) of checked operands."""
    B, c, H, hd = q.shape
    KH = k.shape[2] if k.dim() == 4 else H     # else _check refuses k
    dev = q.device
    _check("q", q, (B, c, H, hd), tuple(_DTYPE_CODE), dev)
    if KH < 1 or H % KH:
        raise ValueError(f"k has {KH} heads, which must divide q's {H} "
                         f"(shape {tuple(k.shape)})")
    _check("k", k, (B, c, KH, hd), (q.dtype,), dev)
    _check("v", v, (B, c, KH, hd), (q.dtype,), dev)
    _check("positions", positions, (B, c), _I32, dev)
    NB, bs = cache_pos.shape if cache_pos.dim() == 2 else (0, 0)
    _check("cache_pos", cache_pos, (NB, bs), _I32, dev)
    _check("cache_k", cache_k, (NB, bs, KH, hd), (q.dtype,), dev)
    _check("cache_v", cache_v, (NB, bs, KH, hd), (q.dtype,), dev)
    if (table is None) != (ring_len is None):
        raise ValueError("a paged pool takes both table and ring_len; a "
                         "dense cache neither")
    if table is None:
        if NB != B:
            raise ValueError(f"a dense cache holds one row per batch row: "
                             f"{NB} rows for B={B}")
        mb, low = 1, bs
    else:
        mb = table.shape[1] if table.dim() == 2 else 0
        _check("table", table, (B, mb), _I32, dev)
        _check("ring_len", ring_len, (B,), _I32, dev)
        if mb < 1:
            raise ValueError("table must map at least one block a row")
        low, high = _ring_range(ring_len)
        if high > mb * bs:
            raise ValueError(f"a ring of {high} slots exceeds the table's "
                             f"{mb * bs}")
    if c > low:
        raise ValueError(f"a chunk of {c} rows exceeds the ring of {low} "
                         "slots (the engines keep c <= ring_len)")
    return B, c, H, KH, hd, NB, bs, mb


def serve_attention(q, k, v, positions, cache_k, cache_v, cache_pos,
                    table=None, ring_len=None, *, window=0):
    """q: (B, c, H, hd) pre-scaled; k/v: (B, c, KH, hd); positions (B, c)
    int32; cache_k/cache_v (NB, bs, KH, hd), cache_pos (NB, bs) int32,
    before the chunk's write; table (B, mb) and ring_len (B,) int32 for a
    paged pool, None for a dense cache (NB == B, one block of L slots a
    row). Returns (B, c, H, hd) in q's dtype."""
    B, c, H, KH, hd, NB, bs, mb = _geometry(q, k, v, positions, cache_k,
                                            cache_v, cache_pos, table,
                                            ring_len)
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not _kernel_device(q):
        return ref.serve_attention_ref(q, k, v, positions, cache_k, cache_v,
                                       cache_pos, table, ring_len,
                                       window=int(window))
    _launch_checks(hd, q, k, v, cache_k, cache_v)
    out = torch.empty_like(q)
    rpw, part, cnt = _scratch(q, KH, mb * bs)  # held until enqueued
    null = ctypes.c_void_p(None)
    err = build.load().serve_attention(
        _DTYPE_CODE[q.dtype], hd, _ptr(q), _ptr(k), _ptr(v), _ptr(positions),
        _ptr(cache_k), _ptr(cache_v), _ptr(cache_pos),
        null if table is None else _ptr(table),
        null if ring_len is None else _ptr(ring_len), _ptr(out),
        null if part is None else _ptr(part),
        null if cnt is None else _ptr(cnt), B, c, H, KH, NB, bs, mb,
        int(window), rpw, _stream(q.device))
    _raise_on(err, "serve_attention")
    serve_attention.launches += 1
    return out


def _launch_checks(hd, *operands):
    if hd not in HEAD_DIMS:
        raise ValueError(f"the serve_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError("serve_attention reads its rows 16 bytes at a "
                         "time: q, k, v and the cache (or the encoder's "
                         "K/V) must start on a 16-byte boundary")


def _scratch(q, KH, n_slots):
    """(rpw, part, count) of a launch over ``n_slots`` logical slots: the
    query rows a warp, and the spans' f32 partials and their counters
    (None when the slots fit one span)."""
    B, c, H, hd = q.shape
    rows = c * (H // KH)
    rpw = 1 if rows <= WARPS else 8
    spans = -(-n_slots // SPAN)
    if spans == 1:
        return rpw, None, None
    groups = -(-rows // (WARPS * rpw))
    return (rpw, torch.empty((B, KH, rows, spans, hd + 4),
                             dtype=torch.float32, device=q.device),
            _counters(q.device, B * KH * groups))


def serve_cross_attention(q, enc_k, enc_v):
    """q: (B, c, H, hd) pre-scaled; enc_k/enc_v: (B, L, KH, hd), H a
    multiple of KH, every key visible to every row. Returns (B, c, H,
    hd) in q's dtype."""
    B, c, H, hd = q.shape
    KH = enc_k.shape[2] if enc_k.dim() == 4 else H   # else _check refuses
    L = enc_k.shape[1] if enc_k.dim() == 4 else 0
    dev = q.device
    _check("q", q, (B, c, H, hd), tuple(_DTYPE_CODE), dev)
    if KH < 1 or H % KH:
        raise ValueError(f"enc_k has {KH} heads, which must divide q's {H} "
                         f"(shape {tuple(enc_k.shape)})")
    _check("enc_k", enc_k, (B, L, KH, hd), (q.dtype,), dev)
    _check("enc_v", enc_v, (B, L, KH, hd), (q.dtype,), dev)
    if L < 1:
        raise ValueError("cross-attention takes at least one key")
    if not _kernel_device(q):
        return ref.serve_cross_attention_ref(q, enc_k, enc_v)
    _launch_checks(hd, q, enc_k, enc_v)
    out = torch.empty_like(q)
    rpw, part, cnt = _scratch(q, KH, L)
    null = ctypes.c_void_p(None)
    err = build.load().serve_cross_attention(
        _DTYPE_CODE[q.dtype], hd, _ptr(q), _ptr(enc_k), _ptr(enc_v),
        _ptr(out), null if part is None else _ptr(part),
        null if cnt is None else _ptr(cnt), B, c, H, KH, L, rpw,
        _stream(dev))
    _raise_on(err, "serve_cross_attention")
    serve_cross_attention.launches += 1
    return out


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"serve_attention": serve_attention,
           "serve_cross_attention": serve_cross_attention}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_counts() -> None:
    """Zero the launch counts of the serving-attention kernel's forms."""
    for fn in KERNELS.values():
        fn.launches = 0
