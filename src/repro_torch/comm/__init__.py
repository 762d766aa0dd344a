"""The pluggable communication plane: compressed client->server uplinks.

A ``CommPlane`` compresses the stacked client deltas (x_k - prev) before
the server update, with a per-cohort error-feedback residual carried in
the round state as ``aux["comm"]`` (so chunked and per-round runs stay
bit-identical), and the server consumes the compressed payload in-kernel
(``kernels.server_plane.server_mix_compressed_tree``).

Registered planes (``FLConfig.comm_plane`` / ``--comm-plane``):

  * ``none`` — dense full precision (``resolve`` returns None and the
    round runs exactly as without this module);
  * ``bf16`` — deltas cast to bfloat16 (2x), exact error feedback;
  * ``q8`` (alias ``int8``) — stochastic int8 with one f32 scale per
    client row per dtype group (~4x); the noise is pure in (seed, t);
  * ``topk`` — top-k magnitude sparsification (``comm_topk_frac`` of
    each dtype group survives as (value, position) pairs).
"""
from repro_torch.comm.plane import (Bf16Plane, CommPlane, Q8Plane,
                                    TopKPlane, decode, dense_bytes, get,
                                    names, register, resolve, wire_fraction)

__all__ = ["CommPlane", "Bf16Plane", "Q8Plane", "TopKPlane", "register",
           "names", "get", "resolve", "wire_fraction", "dense_bytes",
           "decode"]
