"""Comm-plane implementations: bf16 / q8 / top-k with error feedback.

The port's counterpart of the JAX package's ``comm/plane.py``. Every
plane works on the flat per-dtype-group layout of the server kernels
(``utils.tree.dtype_groups`` / ``cat``): the stacked client deltas
``x_k - prev`` of a group are one (K, N_g) f32 matrix, compressed there
and handed to the server as ``groups = [(leaf_idxs, payload)]``, the
input of ``kernels.server_plane.server_mix_compressed_tree``. The
error-feedback residual lives in the same layout, one (C, N_g) f32
tensor per group keyed ``"g0"``, ``"g1"``, ..., carried as
``aux["comm"]``.

Determinism: ``compress`` is a pure function of (t, prev, client
params, residual). The q8 stochastic rounding draws its uniforms from a
counter-based stream pure in (seed, t, group, element): splitmix64
(``env/virtual.py: hash_bits``) computed with integer tensor ops on the
device from the device round index ``t``, so no host read of ``t``, no
generator carried across rounds, and the same bits on the CPU and the
GPU. It is not the JAX package's threefry stream (``jax.random`` cannot
be reproduced in torch); ``q8_encode`` takes the uniforms as an
argument, so tests feed both packages the same draw.

Under a mesh of client width > 1 (``launch.mesh``) a rank compresses
only its own cohort block, rows [r0, r0 + n) of the (C, N_g) stack:
its residual is that block, and its q8 uniforms are drawn at the flat
indices of those rows in the whole stack (``row0``), so its payload is
bitwise the same rows of the one-process payload. ``gather`` then
all-gathers the payloads, compressed (``sharding.ctx.gather_payload``).
"""
from __future__ import annotations

import torch

from repro_torch.env.virtual import hash_bits
from repro_torch.sharding import ctx
from repro_torch.utils import tree

_REGISTRY: dict = {}

# Salt of the stochastic-rounding stream, the JAX package's value: comm
# noise is decorrelated from every other seed-derived stream.
_COMM_SALT = 0x00C0FFEE

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A 64-bit pattern as the signed int64 that holds the same bits."""
    c &= _M64
    return c - (1 << 64) if c >> 63 else c


_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _srl(z, s: int):
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(z):
    """splitmix64 over int64 tensors (wrapping arithmetic), bit for bit
    the numpy uint64 version of ``env/virtual.py``."""
    z = z + _i64(_GOLDEN)
    z = (z ^ _srl(z, 30)) * _i64(_MIX1)
    z = (z ^ _srl(z, 27)) * _i64(_MIX2)
    return z ^ _srl(z, 31)


def q8_uniforms(seed: int, t, group: int, shape, row0: int = 0):
    """(K, N) f32 uniforms in [0, 1) on ``t``'s device: the top 24 bits of
    ``hash_bits(seed, _COMM_SALT, t, group, j)`` (``env/virtual.py``)
    over the flat element index j, times 2^-24. ``t`` is the 0-dim
    device round index; nothing is read on the host. ``row0`` places the
    K rows at rows [row0, row0 + K) of a larger stack of N columns (j
    starts at row0 x N): a rank's cohort block draws the same uniforms
    as those rows of the whole stack's draw."""
    h0 = _i64(int(hash_bits(seed, _COMM_SALT)))
    h = _splitmix64(t.to(torch.int64) ^ h0)
    h = _splitmix64(h ^ group)
    n = 1
    for d in shape:
        n *= d
    j0 = row0 * (n // shape[0]) if n else 0
    j = torch.arange(j0, j0 + n, dtype=torch.int64, device=t.device)
    bits = _srl(_splitmix64(h ^ j), 40)
    return (bits.to(torch.float32) * 2.0 ** -24).reshape(shape)


def register(cls):
    """Class decorator: register a CommPlane under cls.name (+ aliases)."""
    _REGISTRY[cls.name] = cls
    for alias in cls.aliases:
        _REGISTRY[alias] = cls
    return cls


def names():
    return sorted(set(_REGISTRY))


def get(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown comm plane {name!r}; known: none|{'|'.join(names())}"
        ) from None


def resolve(fl):
    """FLConfig -> CommPlane instance, or None for the dense path
    (``comm_plane="none"``: the round runs exactly as without a plane)."""
    if fl.comm_plane in ("none", "", None):
        return None
    return get(fl.comm_plane)(fl)


def dense_bytes(params) -> int:
    """Bytes of one dense uncompressed upload of ``params``."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(params))


def wire_fraction(fl) -> float:
    """Nominal compressed/dense payload ratio, for the bandwidth env,
    which prices airtime before a model exists: the plane's asymptotic
    ratio against an f32 dense upload."""
    if fl.comm_plane in ("none", "", None):
        return 1.0
    return get(fl.comm_plane).nominal_fraction(fl)


class CommPlane:
    """Base class: compress stacked client deltas before the reduction.

    Subclasses implement ``_encode(t, group, e, row0) -> (payload, dq)``
    on one flat (K, N) f32 error matrix ``e`` (delta + residual), rows
    [row0, row0 + K) of the round's stack; the base class owns grouping,
    error feedback, reconstruction, the gather and byte accounting.
    Payloads: ``{"kind": "delta", "d": (K, N) int8|bf16, "scale": (K,)
    f32}`` or ``{"kind": "topk", "v": (K, kk) f32, "i": (K, kk) int32}``.
    ``wire`` names the members a payload sends (``gather``); the others
    are rebuilt where it is received (``_received``).
    """

    name = "base"
    aliases: tuple = ()
    wire = {"delta": ("d", "scale"), "topk": ("v", "i")}

    def __init__(self, fl):
        self.fl = fl
        self.error_feedback = bool(fl.comm_error_feedback)

    def init_residual(self, params, cohort: int):
        """{"g0": (cohort, N_0) f32 zeros, ...}, one entry per dtype group
        of ``params``; {} when error feedback is off."""
        if not self.error_feedback:
            return {}
        leaves = tree.leaves(params)
        return {f"g{gi}": torch.zeros(
                    (cohort, sum(leaves[i].numel() for i in idxs)),
                    dtype=torch.float32, device=leaves[idxs[0]].device)
                for gi, idxs in enumerate(tree.dtype_groups(leaves).values())}

    def compress(self, t, prev_global, client_params, residual,
                 row0: int = 0):
        """(groups, new_residual): the stacked deltas per dtype group,
        plus the carried residual, compressed. Pure in (t, tensors).
        ``row0``: the first row's slot in the whole (C, ...) stack, where
        ``client_params`` and ``residual`` are a rank's cohort block."""
        leaves_p = tree.leaves(prev_global)
        leaves_c = tree.leaves(client_params)
        groups, new_res = [], {}
        for gi, idxs in enumerate(tree.dtype_groups(leaves_p).values()):
            K = leaves_c[idxs[0]].shape[0]
            d = tree.cat([leaves_c[i].reshape(K, -1).float()
                          - leaves_p[i].reshape(-1).float()[None]
                          for i in idxs])
            rk = f"g{gi}"
            e = d + residual[rk] if rk in residual else d
            payload, dq = self._encode(t, gi, e, row0)
            if self.error_feedback:
                new_res[rk] = e - dq
            groups.append((idxs, payload))
        return groups, new_res

    def gather(self, groups):
        """Every client shard's payloads, (C, ...) in cohort order, from
        this rank's block: the ``wire`` members travel in their own
        dtypes. The identity without a process group."""
        got = ctx.gather_payload(groups, self.wire)
        return [(idxs, self._received(p)) for idxs, p in got]

    def _received(self, payload):
        return payload

    def reconstruct(self, prev_global, groups):
        """The stacked client tree ``prev + dequant(payload)``: what the
        server sees when it densifies the upload (strategies without a
        ``compressed_server_update``)."""
        leaves_p = tree.leaves(prev_global)
        out = [None] * len(leaves_p)
        for idxs, payload in groups:
            fp = tree.cat([leaves_p[i].reshape(-1) for i in idxs])
            flat = fp.float()[None, :] + decode(payload, fp.shape[0])
            K = flat.shape[0]
            off = 0
            for i in idxs:
                n = leaves_p[i].numel()
                out[i] = (flat[:, off:off + n]
                          .reshape((K,) + tuple(leaves_p[i].shape))
                          .to(leaves_p[i].dtype))
                off += n
        return tree.unflatten(prev_global, out)

    def payload_bytes(self, params) -> int:
        """Exact bytes one client uploads for one round."""
        leaves = tree.leaves(params)
        return sum(self._group_bytes(sum(leaves[i].numel() for i in idxs))
                   for idxs in tree.dtype_groups(leaves).values())

    def _encode(self, t, group, e, row0):
        raise NotImplementedError

    def _group_bytes(self, n: int) -> int:
        raise NotImplementedError

    @classmethod
    def nominal_fraction(cls, fl) -> float:
        raise NotImplementedError


def decode(payload, n: int):
    """De-quantize one flat payload to its dense (K, n) f32 delta."""
    if payload["kind"] == "delta":
        return payload["d"].float() * payload["scale"][:, None].float()
    if payload["kind"] == "topk":
        v = payload["v"].float()
        return torch.zeros((v.shape[0], n), dtype=torch.float32,
                           device=v.device).scatter_add_(
            1, payload["i"].long(), v)
    raise ValueError(f"unknown payload kind {payload['kind']!r}")


def q8_encode(e, u):
    """Stochastic int8 rows: scale = max|e| / 127 per row, q = floor(y +
    u) with y = e / scale and ``u`` uniforms in [0, 1) shaped like ``e``.
    Unbiased, and |e - q * scale| <= scale elementwise."""
    amax = e.abs().amax(dim=-1)
    # true divisions of tensors: a Python number as divisor or dividend
    # would run as a reciprocal-multiply on the card
    scale = torch.clamp(amax, min=1e-30) / torch.full_like(amax, 127.0)
    y = e / scale[:, None]
    q = torch.clamp(torch.floor(y + u), -127.0, 127.0).to(torch.int8)
    payload = {"kind": "delta", "d": q, "scale": scale}
    return payload, q.float() * scale[:, None]


def bf16_encode(e):
    """bf16 rows, unit scale. The bf16 rounding error of an f32 is exactly
    representable in f32, so error feedback telescopes exactly."""
    q = e.to(torch.bfloat16)
    scale = torch.ones(e.shape[0], dtype=torch.float32, device=e.device)
    payload = {"kind": "delta", "d": q, "scale": scale}
    return payload, q.float()


def topk_encode(e, kk: int):
    """Keep the kk largest-|.| entries per row as (value, position)."""
    _, idx = torch.topk(e.abs(), kk, dim=-1)
    vals = torch.gather(e, -1, idx)
    payload = {"kind": "topk", "v": vals, "i": idx.to(torch.int32)}
    dq = torch.zeros_like(e).scatter_add_(1, idx, vals)
    return payload, dq


@register
class Bf16Plane(CommPlane):
    """Deltas cast to bfloat16 (2x against f32), exact error feedback."""

    name = "bf16"
    #: the unit scales are not sent (``_group_bytes`` counts 2 bytes an
    #: element); the receiver makes them
    wire = {"delta": ("d",)}

    def _encode(self, t, group, e, row0):
        return bf16_encode(e)

    def _received(self, payload):
        d = payload["d"]
        return {**payload, "scale": torch.ones(d.shape[0],
                                               dtype=torch.float32,
                                               device=d.device)}

    def _group_bytes(self, n: int) -> int:
        return 2 * n

    @classmethod
    def nominal_fraction(cls, fl) -> float:
        return 0.5


@register
class Q8Plane(CommPlane):
    """Stochastic-rounded int8 deltas + a per-row f32 scale (~4x)."""

    name = "q8"
    aliases = ("int8",)

    def _encode(self, t, group, e, row0):
        return q8_encode(e, q8_uniforms(self.fl.seed, t, group, e.shape,
                                        row0))

    def _group_bytes(self, n: int) -> int:
        return n + 4        # int8 payload + one f32 scale word

    @classmethod
    def nominal_fraction(cls, fl) -> float:
        return 0.25


@register
class TopKPlane(CommPlane):
    """Top-k magnitude sparsification: keep ``comm_topk_frac`` of each
    dtype group as (f32 value, int32 position) pairs."""

    name = "topk"

    def __init__(self, fl):
        super().__init__(fl)
        self.frac = float(fl.comm_topk_frac)
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(
                f"comm_topk_frac must be in (0, 1], got {self.frac}")

    def _kk(self, n: int) -> int:
        return max(1, min(n, int(self.frac * n)))

    def _encode(self, t, group, e, row0):
        return topk_encode(e, self._kk(e.shape[-1]))

    def _group_bytes(self, n: int) -> int:
        return 8 * self._kk(n)      # f32 value + int32 position per entry

    @classmethod
    def nominal_fraction(cls, fl) -> float:
        return min(1.0, 2.0 * float(fl.comm_topk_frac))
