"""The benchmark's counts: parameters, the FLOPs a round requires, and
the bytes and operations behind each kernel's bound. They are computed
from the configuration and the traffic alone, whatever implements them.

Peaks are the published figures of one NVIDIA H100 SXM (dense, no
sparsity), which assume its full 700 W power limit.
"""
from __future__ import annotations

#: bf16 tensor cores, FLOP/s
BF16_FLOPS = 989e12
#: f32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: HBM3, bytes/s
HBM_BYTES = 3.35e12

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dims(cfg):
    return (cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["num_heads"],
            cfg["num_kv_heads"], cfg["head_dim"], cfg.get("num_experts", 0))


def qkv_params(cfg) -> int:
    d, _, _, H, Hkv, hd, _ = _dims(cfg)
    return d * H * hd + 2 * d * Hkv * hd


def attn_params(cfg) -> int:
    d, _, _, H, _, hd, _ = _dims(cfg)
    return qkv_params(cfg) + H * hd * d


def _mats(cfg) -> int:
    """d x f matrices of an MLP or an expert: 3 gated, 2 without."""
    return 3 if cfg.get("mlp_gated", True) else 2


def ffn_params(cfg) -> int:
    """The MLP's, or every expert's and the router's, parameters."""
    d, f, _, _, _, _, E = _dims(cfg)
    return E * _mats(cfg) * d * f + d * E if E else _mats(cfg) * d * f


def params_by_dtype(cfg) -> dict:
    """{dtype: parameters held in it}: the routers are f32."""
    d, _, V, _, _, _, E = _dims(cfg)
    L = cfg["num_layers"]
    block = attn_params(cfg) + ffn_params(cfg) + 2 * d
    total = 2 * V * d + L * block + d
    router = L * d * E
    out = {cfg["dtype"]: total - router}
    if router:
        out["float32"] = router
    return out


def param_count(cfg) -> int:
    return sum(params_by_dtype(cfg).values())


def touched_block_params(cfg) -> int:
    """Matmul parameters of one block that a token goes through: the
    attention projections and the MLP, or the router and its top-k
    experts."""
    d, f, _, _, _, _, E = _dims(cfg)
    m = _mats(cfg)
    ffn = cfg["top_k"] * m * d * f + d * E if E else m * d * f
    return attn_params(cfg) + ffn


def head_params(cfg) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def causal_pairs(S: int) -> int:
    """Query-key pairs a causal mask lets through."""
    return S * (S + 1) // 2


def attn_fwd_flops(cfg, S: int) -> int:
    """One layer's QK^T and PV over one causal sequence of S."""
    return 4 * cfg["num_heads"] * cfg["head_dim"] * causal_pairs(S)


def full_row_flops(cfg, S: int) -> int:
    """A sequence of an unlimited cohort: forward and backward of every
    layer and the head, 6 x the touched matmul parameters a token, with
    no recomputation."""
    L = cfg["num_layers"]
    mm = L * touched_block_params(cfg) + head_params(cfg)
    return 6 * mm * S + 3 * L * attn_fwd_flops(cfg, S)


def limited_row_flops(cfg, S: int) -> int:
    """A sequence of a limited cohort under FES: the whole forward, and
    the backward its classifier's update needs: the head's and the tail
    blocks' weight and input gradients, less the input gradient of the
    first tail block's q, k, v projections (nothing below it trains)."""
    L = cfg["num_layers"]
    tail = min(cfg["fes_tail_layers"], L)
    fwd = (2 * (L * touched_block_params(cfg) + head_params(cfg)) * S
           + L * attn_fwd_flops(cfg, S))
    bwd = 4 * head_params(cfg) * S
    if tail:
        bwd += tail * (4 * touched_block_params(cfg) * S
                       + 2 * attn_fwd_flops(cfg, S))
        bwd -= 2 * qkv_params(cfg) * S
    return fwd + bwd


def round_flops(cfg, traffic, n_limited: int) -> int:
    """FLOPs one round requires."""
    rows = traffic["local_steps"] * traffic["batch"]
    S = traffic["seq"]
    C = traffic["cohorts"]
    return rows * ((C - n_limited) * full_row_flops(cfg, S)
                   + n_limited * limited_row_flops(cfg, S))


def server_mix_bytes(K: int, N: int, dtype: str) -> int:
    """Bytes of one server_mix launch: K client rows and prev read, the
    new model written."""
    return (K + 2) * N * _SIZE[dtype]


def flash_work(kind: str, B: int, S: int, H: int, Hkv: int, hd: int,
               elem: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one causal flash call of the kind ``fwd``,
    ``bwd_dq`` or ``bwd_dkdv``: q, out, dO, dq at H heads, k, v, dk, dv
    at Hkv heads, the f32 row statistics; the kernels' own products (the
    backward recomputes P in both kernels)."""
    E, Ekv, rows = B * S * H * hd, B * S * Hkv * hd, B * H * S * 4
    n = B * H * causal_pairs(S) * hd
    return {"fwd": ((2 * E + 2 * Ekv) * elem + rows, 4 * n),
            "bwd_dq": ((4 * E + 2 * Ekv) * elem + 2 * rows, 6 * n + 2 * E),
            "bwd_dkdv": ((2 * E + 4 * Ekv) * elem + 2 * rows, 8 * n)}[kind]


def bound_s(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the peak rate."""
    return max(nbytes / HBM_BYTES, flops / flops_per_s)
