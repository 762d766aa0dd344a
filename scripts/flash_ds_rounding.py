"""How often one bf16 rounding of dS breaks the flash kernels' error rule.

The tensor-core flash backward (src/repro_torch/kernels/csrc/
flash_attention_sm90.cu) feeds dS = P * (dP - D) to dQ = dS K and dK =
dS^T Q through bf16 operands. This script emulates that in plain PyTorch
on the CPU, with dS rounded once to bf16 (FlashAttention's rounding) or
carried as two bf16 parts (hi + lo, the kernels' choice), and counts the
draws in which dq or dk breaks chip_smoke.py's rule (the max error against
the plain version in f32 at most twice the plain version's own bf16
error, floor 1e-3 x max|want|). dV is not emulated (the kernels take P
into it as two bf16 parts too).

    PYTHONPATH=src python scripts/flash_ds_rounding.py [--draws 20]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.kernels import ref

#: (hd, causal, window, B, S, H, Hkv): test-size shapes of the gpu tests
CASES = [(64, False, 32, 1, 100, 3, 1), (128, True, 0, 1, 100, 4, 2),
         (64, True, 0, 1, 128, 2, 1), (128, True, 64, 1, 384, 2, 2),
         (128, True, 0, 2, 256, 4, 1), (64, False, 0, 2, 128, 2, 2)]


def rounded(x: torch.Tensor, split: bool) -> torch.Tensor:
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def emulated_grads(dout, q, k, v, lse, delta, causal, window, split):
    """dq, dk as the kernels form them, dS rounded once or split."""
    H, Hkv = q.shape[2], k.shape[2]
    kk, vv = ref._repeat_kv(k, H), ref._repeat_kv(v, H)
    s, mask, scale = ref._scores(q, kk, causal, window, None)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vv.float())
    ds = rounded(p * (dp - delta[..., None]), split)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.bfloat16(), ref._sum_groups(dk, Hkv).bfloat16()


def ratio(got, want32, plain) -> float:
    """error / the rule's bound (above 1 breaks the rule)."""
    err = (got.float() - want32).abs().max().item()
    own = (plain.float() - want32).abs().max().item()
    return err / max(2 * own, 1e-3 * want32.abs().max().item())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args()
    print("hd causal window B S H Hkv | dS rounding | draws breaking the "
          "rule (dq, dk) | worst error / bound (dq, dk)")
    for hd, causal, window, B, S, H, Hkv in CASES:
        kw = dict(causal=causal, window=window)
        worst = {False: [0, 0, 0.0, 0.0], True: [0, 0, 0.0, 0.0]}
        for seed in range(args.draws):
            g = torch.Generator().manual_seed(seed)
            q, dout = (torch.randn(B, S, H, hd, generator=g).bfloat16()
                       for _ in range(2))
            k, v = (torch.randn(B, S, Hkv, hd, generator=g).bfloat16()
                    for _ in range(2))
            out, lse = ref.flash_attention_ref(q, k, v, **kw)
            dq_lo, delta = ref.flash_bwd_dq_ref(dout, q, k, v, out, lse,
                                                **kw)
            dk_lo, _ = ref.flash_bwd_dkdv_ref(dout, q, k, v, lse, delta,
                                              **kw)
            up = [x.float() for x in (dout, q, k, v)]
            dq32, _ = ref.flash_bwd_dq_ref(*up, out.float(), lse, **kw)
            dk32, _ = ref.flash_bwd_dkdv_ref(*up, lse, delta, **kw)
            for split in (False, True):
                dq, dk = emulated_grads(dout, q, k, v, lse, delta, causal,
                                        window, split)
                rq, rk = ratio(dq, dq32, dq_lo), ratio(dk, dk32, dk_lo)
                w = worst[split]
                w[0] += rq > 1
                w[1] += rk > 1
                w[2], w[3] = max(w[2], rq), max(w[3], rk)
        for split in (False, True):
            w = worst[split]
            print(f"{hd} {causal} {window} {B} {S} {H} {Hkv} | "
                  f"{'two parts' if split else 'one bf16'} | "
                  f"{w[0]}/{args.draws}, {w[1]}/{args.draws} | "
                  f"{w[2]:.3f}, {w[3]:.3f}")


if __name__ == "__main__":
    main()
