"""The plain reference of the decoder LMs that the benchmark trains.

Dense and mixture-of-experts decoder stacks in plain PyTorch, written
from the JAX package's equations (``models/transformer.py``,
``attention.py``, ``layers.py``, ``moe.py``) and not from the port:

  * the parameter tree (``embed``, ``body`` and ``tail`` blocks stacked on
    a leading layer axis, ``final_norm``, ``lm_head``) with its
    initialisation rule: U(-s, s) with s = (1 / fan_in) ** 0.5 drawn in
    f32, the embedding N(0, 1) cast to the model dtype and scaled by
    0.02, the draws made in tree order from one generator;
  * RMSNorm (eps 1e-6), rotary embeddings on halves, grouped-query causal
    attention with q scaled by hd ** -0.5 (H heads of hd, whatever
    d_model is), the SwiGLU MLP or, where ``mlp_gated`` is false, two
    matrices around a tanh-approximated GELU;
  * the MoE layer: an f32 router, softmax, top-k by a stable descending
    sort (the lower expert first among equal probabilities), the gates
    renormalised over the top k, a capacity of max(8, ceil8(int(T k cf /
    E))) places an expert with every k = 0 assignment placed before any
    k = 1 and in token order, the assignments past capacity dropped, and
    the Switch aux loss E * sum(mean(probs) * mean(onehot(top1)));
  * the next-token cross entropy over the first S - 1 positions, plus
    0.01 x the summed aux loss.

Every product goes through ``ops.mm``: ``F32`` computes in f32 with
TF32 off, ``FP8`` rounds both operands of each product to float8
(e4m3 forward, e5m2 for the gradient, per-tensor scales) and is the
benchmark's control. Everything else is f32. The parameters keep the
configuration's dtype between steps, as the configuration states.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: top-level keys of the classifier (the FES split, paper Eq. 2)
CLASSIFIER = ("tail", "final_norm", "lm_head")


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class F32:
    """Products in f32 (TF32 off)."""

    @staticmethod
    def mm(a, b):
        return torch.matmul(a, b)


def _q8(x, dtype):
    """(x rounded to ``dtype``, a float8 type, under the per-tensor scale
    that maps its largest magnitude to the type's largest; the scale)."""
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x.detach() * scale).to(dtype), scale


def _dq(q, scale):
    return q.float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b of float8 operands (e4m3), the gradient rounded to e5m2; the
    operands are kept for the backward in float8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, sa = _q8(a, torch.float8_e4m3fn)
        qb, sb = _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb, sa, sb)
        return torch.matmul(_dq(qa, sa), _dq(qb, sb))

    @staticmethod
    def backward(ctx, g):
        qa, qb, sa, sb = ctx.saved_tensors
        g = _dq(*_q8(g, torch.float8_e5m2))
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, _dq(qb, sb).transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            a = _dq(qa, sa)
            if qb.dim() == 2:          # b shared by a's batch: one product
                gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1,
                                                               g.shape[-1])
            else:
                gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


class FP8:
    """Products of float8 operands, accumulated in f32: the control."""

    @staticmethod
    def mm(a, b):
        return _Fp8Matmul.apply(a, b)


# ------------------------------------------------------------- params -----

def init_params(cfg: dict, gen: torch.Generator) -> dict:
    """The model's parameters in ``cfg["dtype"]`` on ``gen``'s device,
    drawn from ``gen`` in tree order (the routers in f32)."""
    dtype = getattr(torch, cfg["dtype"])
    dev = gen.device
    d, V, f = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    H, Hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    E = cfg.get("num_experts", 0)
    gated = cfg.get("mlp_gated", True)

    def uniform(shape, scale, dt=dtype):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return ((2.0 * u - 1.0) * scale).to(dt)

    def dense(d_in, d_out, dt=dtype):
        return {"w": uniform((d_in, d_out), (1.0 / d_in) ** 0.5, dt)}

    def ones():
        return {"g": torch.ones((d,), dtype=dtype, device=dev)}

    def block():
        p = {"ln1": ones(), "ln2": ones(),
             "attn": {"wq": dense(d, H * hd), "wk": dense(d, Hkv * hd),
                      "wv": dense(d, Hkv * hd), "wo": dense(H * hd, d)}}
        if E:
            p["moe"] = {"router": dense(d, E, torch.float32),
                        "w_in": uniform((E, d, f), (1.0 / d) ** 0.5),
                        "w_gate": uniform((E, d, f), (1.0 / d) ** 0.5),
                        "w_out": uniform((E, f, d), (1.0 / f) ** 0.5)}
        else:
            p["mlp"] = {"w_in": dense(d, f), "w_out": dense(f, d)}
            if gated:
                p["mlp"]["w_gate"] = dense(d, f)
        return p

    def stacked(n):
        blocks = [block() for _ in range(n)]
        return _stack(blocks)

    n_tail = min(cfg["fes_tail_layers"], cfg["num_layers"])
    table = torch.randn((V, d), generator=gen, dtype=torch.float32,
                        device=dev)
    params = {"embed": {"table": table.to(dtype) * 0.02}}
    params["body"] = stacked(cfg["num_layers"] - n_tail)
    params["tail"] = stacked(n_tail)
    params["final_norm"] = ones()
    params["lm_head"] = dense(d, V)
    return params


def _stack(blocks):
    if not blocks:
        return None
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def leaves(tree, prefix=""):
    """[(path, tensor)] of a tree in key order (None groups skipped)."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(leaves(v, name + "."))
        elif v is not None:
            out.append((name, v))
    return out


def tree_map(fn, tree):
    return {k: (tree_map(fn, v) if isinstance(v, dict)
                else None if v is None else fn(v)) for k, v in tree.items()}


# ------------------------------------------------------------ forward -----

def rmsnorm(g, x):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * g


def rope(x, theta: float):
    """x: (b, S, heads, hd) at positions 0..S-1; the halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, device=x.device), exps)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, cfg, x, ops):
    b, S, _ = x.shape
    H, Hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    theta = cfg.get("rope_theta", 10000.0)
    q = rope(ops.mm(x, p["wq"]["w"]).view(b, S, H, hd), theta) * hd ** -0.5
    k = rope(ops.mm(x, p["wk"]["w"]).view(b, S, Hkv, hd), theta)
    v = ops.mm(x, p["wv"]["w"]).view(b, S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=2)         # query head h reads
    v = v.repeat_interleave(H // Hkv, dim=2)         # kv head h // n_rep
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, H, S, hd)
    s = ops.mm(q, k.transpose(-1, -2))
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = ops.mm(torch.softmax(s, dim=-1), v)
    return ops.mm(o.transpose(1, 2).reshape(b, S, H * hd), p["wo"]["w"])


def mlp(p, x, ops):
    """SwiGLU where the block has a gate, else GELU (tanh form)."""
    h = ops.mm(x, p["w_in"]["w"])
    if "w_gate" in p:
        h = F.silu(ops.mm(x, p["w_gate"]["w"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return ops.mm(h, p["w_out"]["w"])


def capacity(tokens: int, cfg) -> int:
    cap = int(tokens * cfg["top_k"] * cfg["capacity_factor"]
              / cfg["num_experts"])
    return max(8, ((cap + 7) // 8) * 8)


def route(probs, cfg):
    """(expert, place, gate, kept), each (T, k), of T tokens' routing:
    the top k by a stable descending sort, gates renormalised, places in
    each expert's buffer (k = 0 first, then token order), an assignment
    past capacity not kept and its gate zeroed."""
    T, E = probs.shape
    K = cfg["top_k"]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    gate = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    order = idx.t().reshape(-1)                      # k-major, token order
    hot = F.one_hot(order, E)
    place = ((torch.cumsum(hot, 0) - hot) * hot).sum(-1)
    place = place.reshape(K, T).t()
    kept = place < capacity(T, cfg)
    return idx, place, gate * kept, kept


def moe(p, cfg, x, ops):
    """x: (b, S, d) -> (out (b, S, d), aux loss)."""
    b, S, d = x.shape
    E, K = cfg["num_experts"], cfg["top_k"]
    xt = x.reshape(b * S, d)
    T = xt.shape[0]
    if cfg.get("moe_group_size") and T > cfg["moe_group_size"]:
        raise NotImplementedError("the reference routes one group a "
                                  "sequence batch (T <= moe_group_size)")
    probs = torch.softmax(xt @ p["router"]["w"], dim=-1)   # f32 router
    idx, place, gate, kept = route(probs, cfg)
    C = capacity(T, cfg)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, K)[kept]
    slot = (idx * C + place)[kept]
    xe = torch.zeros(E * C, d, dtype=xt.dtype, device=x.device)
    xe = xe.index_add(0, slot, xt[tok]).view(E, C, d)
    h = ops.mm(xe, p["w_in"])
    g = ops.mm(xe, p["w_gate"])
    ye = ops.mm(F.silu(g) * h, p["w_out"]).reshape(E * C, d)
    out = torch.zeros(T, d, dtype=xt.dtype, device=x.device)
    out = out.index_add(0, tok, ye[slot] * gate[kept][:, None])
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    return out.view(b, S, d), E * torch.sum(me * ce)


def block(stack, i, cfg, x, ops):
    """Block i of a stacked group on x: (x, its aux loss)."""
    p = tree_map(lambda a: a[i].float(), stack)
    x = x + attention(p["attn"], cfg, rmsnorm(p["ln1"]["g"], x), ops)
    h = rmsnorm(p["ln2"]["g"], x)
    if "moe" in p:
        y, a = moe(p["moe"], cfg, h, ops)
    else:
        y, a = mlp(p["mlp"], h, ops), torch.zeros((), device=x.device)
    return x + y, a


def loss_fn(params, cfg, tokens, ops=F32):
    """Mean next-token cross entropy of tokens (b, S) + 0.01 x aux. Each
    parameter is taken in f32 where it is used, so leaves kept in the
    model's dtype cost an f32 copy only for the layer at hand. Each block
    keeps only its input for the backward and computes its forward again
    there, so that the f32 (H, S, S) scores of every layer at once do not
    have to fit on the card."""
    x = params["embed"]["table"][tokens.long()].float()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group in ("body", "tail"):
        stack = params[group]
        if stack is None:
            continue
        for i in range(stack["ln1"]["g"].shape[0]):
            x, a = checkpoint(block, stack, i, cfg, x, ops,
                              use_reentrant=False)
            aux = aux + a
    x = rmsnorm(params["final_norm"]["g"].float(), x)[:, :-1]
    logits = ops.mm(x, params["lm_head"]["w"].float())
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1).long())
    return nll + 0.01 * aux
