"""The decoder stack of the dense and ssm (RWKV-6) families (the port of
the JAX package's ``models/transformer.py`` for ``family`` "dense" and
"ssm").

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
CPU and, with the deterministic kernels, on the card. The hybrid, moe,
vlm and audio families raise NotImplementedError: they come with later
slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import rwkv6
from repro_torch.models.layers import (chunked_cross_entropy, dense,
                                       dense_init, embedding, embedding_init,
                                       mlp, mlp_init, rmsnorm, rmsnorm_init)
from repro_torch.utils.tree import leaves, tree_map, unflatten

#: family -> the slice of the port that brings it
_LATER = {"hybrid": "the mamba2/hybrid slice",
          "moe": "the MoE slice", "vlm": "the VLM slice",
          "audio": "the encoder-decoder slice"}


def check_family(cfg) -> None:
    family = "moe" if cfg.num_experts else cfg.family
    if family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"model family {family!r} ({cfg.name}) is not ported yet: it "
            f"comes with {_LATER.get(family, 'a later slice')}")


# ------------------------------------------------------------- blocks ------

def block_init(gen: torch.Generator, cfg, dtype) -> dict:
    """One block of the config's family."""
    check_family(cfg)
    if cfg.family == "ssm":                       # rwkv6
        return {"rwkv": rwkv6.rwkv6_init(gen, cfg, dtype),
                "ln1": rmsnorm_init(cfg.d_model, dtype),
                "ln2": rmsnorm_init(cfg.d_model, dtype)}
    return {"ln1": rmsnorm_init(cfg.d_model, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype),
            "attn": attn.attn_init(gen, cfg, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.mlp_gated)}


def _stacked_block_init(gen: torch.Generator, cfg, n: int, dtype):
    """n blocks stacked on a leading layer axis (None when n == 0)."""
    if n == 0:
        return None
    blocks = [block_init(gen, cfg, dtype) for _ in range(n)]
    return unflatten(blocks[0], [torch.stack(xs) for xs
                                 in zip(*(leaves(b) for b in blocks))])


def block_fwd(p, cfg, x, positions, aux):
    """Full-sequence block application. Returns (x, aux). An rwkv6
    block starts from a fresh zero state and drops the new one, as in
    the JAX package."""
    if cfg.family == "ssm":
        st = rwkv6.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
        h, st = rwkv6.time_mix(p["rwkv"], cfg, rmsnorm(p["ln1"], x), st)
        x = x + h
        h, _ = rwkv6.channel_mix(p["rwkv"], rmsnorm(p["ln2"], x), st)
        return x + h, aux
    h = attn.attention_fwd(p["attn"], cfg, rmsnorm(p["ln1"], x), positions)
    x = x + h
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


def _run_blocks(stacked, cfg, x, positions, aux):
    """Apply a stacked group of blocks, layer by layer, each under
    ``_BlockRemat`` when ``cfg.remat``."""
    if stacked is None:
        return x, aux
    for i in range(leaves(stacked)[0].shape[0]):
        p = tree_map(lambda a, i=i: a[i], stacked)
        if cfg.remat:
            x, aux = _BlockRemat.apply(x, aux, positions,
                                       tree_map(lambda _: 0, p), cfg,
                                       *leaves(p))
        else:
            x, aux = block_fwd(p, cfg, x, positions, aux)
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
    return tree_map(lambda x: x.to(device), params)


# ------------------------------------------------------------ forward ------

def embed_inputs(params, cfg, batch):
    """Returns (x, positions): the token embeddings and the aligned
    positions 0..S-1."""
    x = embedding(params["embed"], batch["tokens"])
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def hidden_states(params, cfg, batch):
    """Final-norm hidden states (no logits) and the aux loss (0 for the
    dense and ssm families)."""
    x, positions = embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _run_blocks(params["body"], cfg, x, positions, aux)
    x, aux = _run_blocks(params["tail"], cfg, x, positions, aux)
    return rmsnorm(params["final_norm"], x), aux


def forward(params, cfg, batch):
    """Full-sequence logits (B, S, V) and the aux loss."""
    x, aux = hidden_states(params, cfg, batch)
    return dense(params["lm_head"], x), aux


def loss_fn(params, cfg, batch):
    """Next-token CE (+ 0.01 x the aux loss), chunked over the sequence
    so the logits never form at (B, S, V)."""
    x, aux = hidden_states(params, cfg, batch)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1)
    loss = chunked_cross_entropy(x, params["lm_head"], labels, mask)
    return loss + 0.01 * aux
