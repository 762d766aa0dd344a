"""The CUDA kernels against their plain PyTorch versions on the card, and
remat on == off on the card. Marked ``gpu``: they skip on a machine without a CUDA device
(the kernels have no CPU mode). This file imports no JAX, so it runs on
the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dt):
    """The CUDA kernels against their plain versions on the card: the same
    op order and per-op rounding, so at most a few ulp (library exp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    K, N, Q = 3, 1000 + 3, 4
    prev = torch.randn(N, device=dev, generator=g).to(dt)
    stacked = torch.randn(K, N, device=dev, generator=g).to(dt)
    sizes = torch.rand(K, device=dev, generator=g) + 0.5
    for keep in (torch.tensor([1.0, 0.0, 1.0], device=dev),
                 torch.zeros(K, device=dev)):
        coefs = torch.tensor([0.1, 2.5e-3, 0.95, 5.0], device=dev)
        tsp.reset_counts()
        got = tsp.server_mix_flat(prev, stacked, sizes, keep, coefs)
        assert tsp.server_mix_flat.launches == 1
        want = tref.server_mix_math(prev, stacked, sizes, keep, coefs)
        torch.testing.assert_close(got, want, rtol=4 * 2 ** -23 if
                                   dt == torch.float32 else 2 ** -7,
                                   atol=1e-6)
    qsum = torch.randn(Q, N, device=dev, generator=g)
    qgamma = torch.rand(Q, device=dev, generator=g)
    delayed = torch.tensor([1.0, 0.0, 1.0], device=dev)
    delays = torch.tensor([2, 1, 3], device=dev, dtype=torch.int32)
    tq = torch.tensor([6, 6 % Q], device=dev, dtype=torch.int32)
    hyp = torch.tensor([0.1, 2.5e-3, 0.95, 0.6], device=dev)
    args = (prev, stacked, qsum, qgamma, sizes, delayed, delays, tq, hyp)
    for g_, w_ in zip(tsp.server_async_flat(*args),
                      tref.server_async_math(*args)):
        torch.testing.assert_close(g_.float(), w_.float(), rtol=2 ** -7
                                   if g_.dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-6)


@pytest.mark.gpu
def test_kernels_refuse_shapes_beyond_their_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    K, N, Q = 2, 64, tsp.MAX_Q + 1
    f = dict(device=dev)
    with pytest.raises(ValueError):
        tsp.server_async_flat(
            torch.zeros(N, **f), torch.zeros(K, N, **f),
            torch.zeros(Q, N, **f), torch.zeros(Q, **f), torch.ones(K, **f),
            torch.zeros(K, **f), torch.ones(K, dtype=torch.int32, **f),
            torch.zeros(2, dtype=torch.int32, **f), torch.zeros(4, **f))
    with pytest.raises(ValueError):
        K = tsp.MAX_K + 1
        tsp.server_mix_flat(torch.zeros(N, **f), torch.zeros(K, N, **f),
                            torch.ones(K, **f), torch.ones(K, **f),
                            torch.zeros(4, **f))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fedopt_and_compressed_kernels_equal_plain_on_card(dt):
    """server_adam, server_mix_delta (int8 and bf16 rows) and
    server_mix_scatter (positions colliding across clients, K-fold, and
    K at its limit) against their plain versions on the card: the same
    op order with every operation rounded on its own, so bit for bit;
    one scatter call is one (cooperative) launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    K, N, kk = 3, 1000 + 3, 100
    prev = torch.randn(N, device=dev, generator=g).to(dt)
    sizes = torch.rand(K, device=dev, generator=g) + 0.5
    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 5.0], device=dev)
    for keep in (torch.tensor([1.0, 0.0, 1.0], device=dev),
                 torch.zeros(K, device=dev)):
        tsp.reset_counts()
        stacked = (prev.float()[None] + 0.1 * torch.randn(
            K, N, device=dev, generator=g)).to(dt)
        m = 1e-3 * torch.randn(N, device=dev, generator=g)
        v = 1e-6 * torch.rand(N, device=dev, generator=g)
        for step in (1.0, 7.0):
            sc = torch.tensor([0.9, 0.99, 0.1, 1e-3, step], device=dev)
            args = (prev, stacked, m, v, sizes, keep, sc)
            for got, want in zip(tsp.server_adam_flat(*args),
                                 tref.server_adam_math(*args)):
                assert torch.equal(got, want)
        q8 = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                           dtype=torch.int8)
        bf = (0.1 * torch.randn(K, N, device=dev, generator=g)).bfloat16()
        scale = torch.rand(K, device=dev, generator=g) * 0.01
        for rows, rs in ((q8, scale), (bf, torch.ones(K, device=dev))):
            args = (prev, rows, rs, sizes, keep, coefs)
            assert torch.equal(tsp.server_mix_delta_flat(*args),
                               tref.server_mix_delta_math(*args))
        for layout in _SCATTER_LAYOUTS:
            args = _scatter_args(dev, g, prev, sizes, keep, coefs, kk,
                                 layout)
            assert torch.equal(tsp.server_mix_scatter_flat(*args),
                               tref.server_mix_scatter_math(*args)), layout
        assert (tsp.server_adam_flat.launches,
                tsp.server_mix_delta_flat.launches,
                tsp.server_mix_scatter_flat.launches) == (
                    2, 2, len(_SCATTER_LAYOUTS))


#: top-k position layouts of the scatter test: rows that are windows of
#: one permutation shifted by kk/2 (distinct within a row, half of each
#: row colliding with the row before); every row the same positions in
#: another order (K-fold collisions); K at the kernel's limit
_SCATTER_LAYOUTS = ("windows", "K-fold", "K = MAX_K")


def _scatter_args(dev, g, prev, sizes, keep, coefs, kk, layout):
    N, K = prev.shape[0], sizes.shape[0]
    if layout == "K = MAX_K":
        K = tsp.MAX_K
        sizes = torch.rand(K, device=dev, generator=g) + 0.5
        keep = keep.repeat(-(-K // keep.shape[0]))[:K].contiguous()
    perm = torch.randperm(N, device=dev, generator=g)
    if layout == "K-fold":
        idx = torch.stack([perm[:kk][torch.randperm(kk, device=dev,
                                                    generator=g)]
                           for _ in range(K)])
    else:
        idx = torch.stack([perm[(k * kk // 2 + torch.arange(kk, device=dev))
                                % N] for k in range(K)])
    vals = torch.randn(K, kk, device=dev, generator=g)
    return prev, vals, idx.to(torch.int32), sizes, keep, coefs


def _ama_mix_cases(dev, g):
    """The phase-3 cases of chip_smoke.py at test size: K = 1 f32 and bf16
    at the paper CNN's leaf sizes and at its whole size, K = 2 over the
    async operand (f32 rows under f32 and bf16 prev), K = 1 with
    alpha = 1 (fedopt), a ragged N."""
    f32, bf16 = torch.float32, torch.bfloat16
    for N in (250, 5000, 38400, 120, 10080, 84, 840, 10, 54_784):
        for dt in (f32, bf16):
            yield 1, N, dt, dt, 0.37
    for dt in (f32, bf16):
        yield 2, 38400, dt, f32, 0.21
    yield 1, 38400, f32, f32, 1.0
    yield 3, 1000 + 3, f32, f32, 0.5


@pytest.mark.gpu
def test_ama_mix_kernel_equals_plain_on_card():
    """The ama_mix kernel against ama_mix_math on the card, bit for bit
    (every multiply and add rounded on its own in the same order), one
    launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.ama_mix import ama_mix_flat
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    tsp.reset_counts()
    n = 0
    for K, N, pdt, sdt, a in _ama_mix_cases(dev, g):
        prev = torch.randn(N, device=dev, generator=g).to(pdt)
        stacked = torch.randn(K, N, device=dev, generator=g).to(sdt)
        alpha = torch.full((1,), a, device=dev)
        w = torch.rand(K, device=dev, generator=g)
        got = ama_mix_flat(prev, stacked, alpha, w)
        want = tref.ama_mix_math(prev, stacked, alpha, w)
        n += 1
        assert got.dtype == pdt and torch.equal(got, want), (K, N, pdt, sdt)
    assert ama_mix_flat.launches == n


def _within_flash_rule(got, want32, plain):
    """FlashAttention's own rule: in bf16 the kernel's max error against
    the plain version run in f32 (on the same bf16 inputs) is at most
    twice the plain version's own error when run in bf16, with a floor
    of 1e-3 x max|want|; in f32, atol 1e-5 + rtol 1e-5 against the plain
    version."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want32, rtol=1e-5, atol=1e-5)
    err = (got.float() - want32).abs().max()
    own = (plain.float() - want32).abs().max()
    return bool(err <= max(2 * own, 1e-3 * want32.abs().max()))


#: (dtype, hd, causal, window, B, S, H): the phase-3 cases of
#: chip_smoke.py at test size, ragged S = 100 (one partial tile) in f32
#: and bf16 included; kv head-repeated (Hkv = H)
FLASH_CASES = [("bfloat16", 128, True, 0, 2, 256, 4),
               ("bfloat16", 64, True, 0, 1, 128, 2),
               ("bfloat16", 96, True, 0, 2, 128, 2),
               ("float32", 128, True, 0, 1, 256, 2),
               ("bfloat16", 128, True, 64, 1, 384, 2),
               ("bfloat16", 64, False, 0, 2, 128, 2),
               ("float32", 64, False, 32, 1, 100, 3),
               ("bfloat16", 128, True, 0, 1, 64, 1),
               ("bfloat16", 64, False, 32, 1, 100, 3)]

#: (dtype, hd, causal, window, B, S, H, Hkv): kv at fewer heads (GQA,
#: n_rep 2, 3 and 4; minitron's 32 over 8 at test size), both designs
FLASH_GQA_CASES = [("bfloat16", 128, True, 0, 2, 256, 8, 2),
                   ("bfloat16", 64, True, 0, 1, 384, 4, 2),
                   ("bfloat16", 96, False, 0, 1, 128, 6, 2),
                   ("bfloat16", 128, True, 64, 1, 384, 4, 1),
                   ("bfloat16", 128, True, 0, 1, 100, 4, 2),
                   ("float32", 128, True, 0, 1, 256, 4, 2),
                   ("float32", 64, False, 32, 1, 100, 3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt,hd,causal,window,B,S,H", FLASH_CASES)
def test_flash_kernels_match_plain_on_card(dt, hd, causal, window, B, S, H):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkdv against their plain
    versions on the same inputs, one launch each, on the dtype's design."""
    _check_flash_on_card(dt, hd, causal, window, B, S, H, H)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,hd,causal,window,B,S,H,Hkv", FLASH_GQA_CASES)
def test_flash_kernels_match_plain_on_card_gqa(dt, hd, causal, window, B, S,
                                               H, Hkv):
    """The same with k and v at Hkv < H heads: query head h reads kv head
    h // (H // Hkv), dk and dv sum over the query heads of each kv
    head."""
    _check_flash_on_card(dt, hd, causal, window, B, S, H, Hkv)


#: (dtype, hd, causal, window, B, Sq, Skv, H, Hkv): any length and
#: cross-attention (Sq != Skv), both designs: ragged S 129 and 200, the
#: vlm's 2,624 rows at hd 96, whisper's encoder (1,500, non-causal), its
#: cross-attention at test size and a single query row
FLASH_ANY_CASES = [("bfloat16", 64, True, 0, 1, 129, 129, 2, 2),
                   ("float32", 64, True, 0, 1, 200, 200, 2, 1),
                   ("bfloat16", 96, True, 0, 1, 2624, 2624, 2, 2),
                   ("bfloat16", 64, False, 0, 1, 1500, 1500, 2, 2),
                   ("float32", 64, False, 0, 1, 1500, 1500, 2, 2),
                   ("bfloat16", 64, False, 0, 2, 200, 1500, 4, 2),
                   ("float32", 64, False, 0, 2, 129, 300, 2, 2),
                   ("bfloat16", 64, False, 0, 1, 1, 1500, 2, 2),
                   ("float32", 96, False, 0, 1, 1, 100, 2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt,hd,causal,window,B,Sq,Skv,H,Hkv",
                         FLASH_ANY_CASES)
def test_flash_kernels_match_plain_on_card_any_length(dt, hd, causal,
                                                      window, B, Sq, Skv, H,
                                                      Hkv):
    """The three kernels at ragged lengths and with q against k, v of
    another length: outputs within FlashAttention's rule, dk and dv at
    Skv rows, nothing stored past either length."""
    _check_flash_on_card(dt, hd, causal, window, B, Sq, H, Hkv, Skv)


def _check_flash_on_card(dt, hd, causal, window, B, S, H, Hkv, Skv=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import flash_attention as tfa
    torch.backends.cuda.matmul.allow_tf32 = False
    design = {"bfloat16": "wgmma", "float32": "cuda_cores"}[dt]
    dev, dt = torch.device("cuda"), getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(3)
    Skv = S if Skv is None else Skv
    q, k, v, dout = (torch.randn(B, n, h, hd, device=dev, generator=g)
                     .to(dt) for n, h in ((S, H), (Skv, Hkv), (Skv, Hkv),
                                          (S, H)))
    kw = dict(causal=causal, window=window)
    tfa.reset_counts()
    before = tfa.design_launches()
    up = [x.float() for x in (dout, q, k, v)]
    out32, lse32 = tref.flash_attention_ref(*up[1:], **kw)
    out_lo, lse_lo = tref.flash_attention_ref(q, k, v, **kw)
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    assert _within_flash_rule(out, out32, out_lo)
    torch.testing.assert_close(lse, lse_lo, rtol=1e-5, atol=1e-5)
    # the backward passes on the plain forward's outputs
    dq32, d32 = tref.flash_bwd_dq_ref(*up, out_lo.float(), lse_lo, **kw)
    dq_lo, d_lo = tref.flash_bwd_dq_ref(dout, q, k, v, out_lo, lse_lo, **kw)
    dq, delta = tfa.flash_bwd_dq(dout, q, k, v, out_lo, lse_lo, **kw)
    assert _within_flash_rule(dq, dq32, dq_lo)
    torch.testing.assert_close(delta, d_lo, rtol=1e-5, atol=1e-5)
    dk32, dv32 = tref.flash_bwd_dkdv_ref(*up, lse_lo, d_lo, **kw)
    dk_lo, dv_lo = tref.flash_bwd_dkdv_ref(dout, q, k, v, lse_lo, d_lo, **kw)
    dk, dv = tfa.flash_bwd_dkdv(dout, q, k, v, lse_lo, d_lo, **kw)
    assert _within_flash_rule(dk, dk32, dk_lo)
    assert _within_flash_rule(dv, dv32, dv_lo)
    assert dk.shape == k.shape and dv.shape == v.shape
    assert all(fn.launches == 1 for fn in tfa.KERNELS.values())
    after = tfa.design_launches()
    for name in tfa.KERNELS:    # bf16 never reaches the CUDA-core kernels
        assert {d: after[name][d] - before[name][d] for d in tfa.DESIGNS} \
            == {d: int(d == design) for d in tfa.DESIGNS}, name


@pytest.mark.gpu
def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import flash_attention as tfa
    dev = torch.device("cuda")
    for S, hd, dt in ((128, 80, torch.bfloat16), (128, 64, torch.float16)):
        x = torch.zeros(1, S, 2, hd, device=dev, dtype=dt)
        with pytest.raises((ValueError, TypeError)):
            tfa.flash_attention(x, x, x)
    x = torch.zeros(1, 200, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cross-attention"):
        tfa.flash_attention(x, x[:, :128], x[:, :128])   # causal, Sq != Skv
    q = torch.zeros(1, 128, 6, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 128, 4, 64, device=dev, dtype=torch.bfloat16)
    for fn in (tfa.flash_attention, tfa.flash_fwd):
        with pytest.raises(ValueError, match="must divide"):
            fn(q, kv, kv)


#: (B, S, H, hd, decay range, u scale): the phase-3 cases of
#: chip_smoke.py at test size; S = 100 and 2047 leave a ragged last
#: segment, S = 16 is exactly one, S = 1 is the serving path's decode
RWKV6_CASES = [(2, 256, 4, 64, (0.4, 0.9), 0.1),
               (1, 64, 1, 16, (0.4, 0.9), 0.1),
               (1, 100, 2, 32, (0.4, 0.9), 0.5),
               (2, 96, 2, 64, (2e-24, 1e-23), 0.1),
               (2, 96, 2, 64, (0.99966, 0.99966), 0.1),
               (2, 16, 4, 64, (0.4, 0.9), 0.1),
               (1, 2047, 2, 64, (0.4, 0.9), 0.1),
               (4, 1, 40, 64, (0.4, 0.9), 0.1)]      # a decode step


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,decay,us", RWKV6_CASES)
def test_rwkv6_kernels_match_plain_on_card(B, S, H, hd, decay, us):
    """rwkv6_fwd and rwkv6_bwd against their plain versions on the same
    inputs, s0 and d(s_final) non-zero, one wrapper call each: every
    output within 1e-5 x (1 + max |plain|) (f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import rwkv6_scan as trs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    r, k, v, dy = (torch.randn(B, S, H, hd, device=dev, generator=g) * 0.5
                   for _ in range(4))
    lo, hi = decay
    w = lo + (hi - lo) * torch.rand(B, S, H, hd, device=dev, generator=g)
    u = us * torch.randn(B, H, hd, device=dev, generator=g)  # per row
    s0, ds = (0.1 * torch.randn(B, H, hd, hd, device=dev, generator=g)
              for _ in range(2))
    trs.reset_counts()
    got = trs.rwkv6_fwd(r, k, v, w, u, s0)
    want = tref.rwkv6_scan_ref(r, k, v, w, u, s0)
    got_b = trs.rwkv6_bwd(dy, ds, r, k, v, w, u, want[2])
    want_b = tref.rwkv6_scan_bwd_ref(dy, ds, r, k, v, w, u, want[2])
    for a, b in zip((*got, *got_b), (*want, *want_b)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * (
            1 + float(b.abs().max()))
    assert all(fn.launches == 1 for fn in trs.KERNELS.values())


@pytest.mark.gpu
def test_rwkv6_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import rwkv6_scan as trs
    dev = torch.device("cuda")
    for hd, dt in ((128, torch.float32), (48, torch.float32),
                   (64, torch.bfloat16)):
        x = torch.zeros(1, 32, 2, hd, device=dev, dtype=dt)
        with pytest.raises((ValueError, TypeError)):
            trs.rwkv6_fwd(x, x, x, x,
                          torch.zeros(1, 2, hd, device=dev, dtype=dt),
                          torch.zeros(1, 2, hd, hd, device=dev, dtype=dt))
    # both kernels stage r, k, v, w (and dy) 16 bytes at a time
    x = torch.zeros(1, 32, 2, 64, device=dev)
    u, s0 = torch.zeros(1, 2, 64, device=dev), torch.zeros(1, 2, 64, 64,
                                                           device=dev)
    _, _, states = trs.rwkv6_fwd(x, x, x, x, u, s0)
    off = torch.zeros(x.numel() + 1, device=dev)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        trs.rwkv6_bwd(off, s0, x, x, x, x, u, states)
    with pytest.raises(ValueError, match="16-byte"):
        trs.rwkv6_fwd(x, x, off, x, u, s0)


def _device_kernels(fn):
    """Names of the device kernels one ``fn()`` call runs (a
    torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            for _ in range(e.count) if "_kernel" in e.key]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2048, 100])
def test_rwkv6_fwd_is_two_launches_a_call(S):
    """One rwkv6_fwd call runs two device kernels, the boundary scan and
    the segments, once each, and counts one call; two calls on the same
    inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import rwkv6_scan as trs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, hd = 2, 4, 64
    r, k, v = (0.5 * torch.randn(B, S, H, hd, device=dev, generator=g)
               for _ in range(3))
    w = 0.4 + 0.5 * torch.rand(B, S, H, hd, device=dev, generator=g)
    u = 0.1 * torch.randn(B, H, hd, device=dev, generator=g)
    s0 = 0.1 * torch.randn(B, H, hd, hd, device=dev, generator=g)
    trs.reset_counts()
    names = _device_kernels(lambda: trs.rwkv6_fwd(r, k, v, w, u, s0))
    assert trs.rwkv6_fwd.launches == 1
    assert sorted(re.search(r"\w+_kernel", n).group(0) for n in names) == [
        "rwkv6_fwd_scan_kernel", "rwkv6_fwd_seg_kernel"], names
    a, b = trs.rwkv6_fwd(r, k, v, w, u, s0), trs.rwkv6_fwd(r, k, v, w, u, s0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


#: (B, S, H, N, decay range, h0 scale): chip_smoke.py's mamba2 cases at
#: test size; S = 100 leaves a ragged last chunk, S = 64 is exactly one,
#: S = 1 the serving path's decode step; a third decay entry is the share
#: of steps whose decay is exactly 0, and (1.0, 1.0) is a = 1 throughout
MAMBA2_CASES = [(2, 256, 4, 64, (0.3, 0.99), 0.3),
                (1, 100, 8, 16, (0.3, 0.99), 0.3),
                (2, 64, 2, 32, (0.3, 0.99), 0.0),
                (2, 130, 2, 64, (0.0, 1e-30), 0.3),
                (2, 130, 2, 64, (0.9999, 1.0), 0.3),
                (2, 200, 3, 64, (0.3, 0.99, 0.2), 0.3),   # exact zeros
                (2, 192, 2, 32, (1.0, 1.0), 0.3),         # a = 1
                (4, 1, 64, 64, (0.3, 0.99), 0.3)]      # a decode step


def _mamba2_inputs(dev, g, B, S, H, N, decay, hs):
    lo, hi = decay[:2]
    a = lo + (hi - lo) * torch.rand(B, S, H, device=dev, generator=g)
    if len(decay) > 2:
        a = a.masked_fill(torch.rand(B, S, H, device=dev, generator=g)
                          < decay[2], 0.0)
    x, dy = (0.5 * torch.randn(B, S, H, 64, device=dev, generator=g)
             for _ in range(2))
    Bm, Cm = (torch.randn(B, S, N, device=dev, generator=g)
              for _ in range(2))
    h0, dh = (hs * torch.randn(B, H, 64, N, device=dev, generator=g)
              for _ in range(2))
    return a, x, Bm, Cm, h0, dy, dh


def _within_rule(got, want):
    """Every pair within 1e-5 x (1 + max |plain|)."""
    for a_, b_ in zip(got, want, strict=True):
        assert a_.shape == b_.shape
        assert float((a_ - b_).abs().max()) <= 1e-5 * (
            1 + float(b_.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,N,decay,hs", MAMBA2_CASES)
def test_mamba2_kernels_match_plain_on_card(B, S, H, N, decay, hs):
    """mamba2_fwd and mamba2_bwd against their plain versions on the same
    inputs, h0 and d(h_final) non-zero (but in one case), one wrapper
    call each: every output, h_final and the states among them, within
    1e-5 x (1 + max |plain|) (the chunk form sums in another order than
    the per-step recurrence); the backward on the kernel's own states
    (the pod path's pairing) within the same rule of the plain backward
    on the plain states; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import mamba2_scan as tms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    a, x, Bm, Cm, h0, dy, dh = _mamba2_inputs(dev, g, B, S, H, N, decay, hs)
    tms.reset_counts()
    got = tms.mamba2_fwd(a, x, Bm, Cm, h0)
    want = tref.mamba2_scan_ref(a, x, Bm, Cm, h0)
    got_b = tms.mamba2_bwd(dy, dh, a, x, Bm, Cm, want[2])
    want_b = tref.mamba2_scan_bwd_ref(dy, dh, a, x, Bm, Cm, want[2])
    _within_rule((*got, *got_b), (*want, *want_b))
    assert all(fn.launches == 1 for fn in tms.KERNELS.values())
    own_b = tms.mamba2_bwd(dy, dh, a, x, Bm, Cm, got[2])
    _within_rule(own_b, want_b)
    again = (*tms.mamba2_fwd(a, x, Bm, Cm, h0),
             *tms.mamba2_bwd(dy, dh, a, x, Bm, Cm, got[2]))
    assert all(torch.equal(u, v) for u, v in zip(again, (*got, *own_b)))


@pytest.mark.gpu
def test_mamba2_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import mamba2_scan as tms
    dev = torch.device("cuda")
    for P, N in ((32, 64), (64, 128), (64, 8)):
        x = torch.zeros(1, 8, 2, P, device=dev)
        bc = torch.zeros(1, 8, N, device=dev)
        with pytest.raises(ValueError, match="mamba2 kernels take"):
            tms.mamba2_fwd(torch.zeros(1, 8, 2, device=dev), x, bc, bc,
                           torch.zeros(1, 2, P, N, device=dev))
    a = torch.zeros(1, 8, 2, device=dev)
    x, bc = torch.zeros(1, 8, 2, 64, device=dev), torch.zeros(1, 8, 16,
                                                              device=dev)
    off = torch.zeros(x.numel() + 1, device=dev)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        tms.mamba2_fwd(a, off, bc, bc, torch.zeros(1, 2, 64, 16, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_server_mix_vector_and_per_element_kernels_bitwise(dt):
    """server_mix takes its 16-byte kernel where N is a multiple of the
    vector (4 f32, 8 bf16) and every operand starts on a 16-byte
    boundary, and its per-element kernel otherwise (N off the vector, or
    a base pointer offset by one element); both equal the plain version
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    # (K, N, element offset of prev / stacked / out, the kernel expected)
    cases = [(2, 8 * 1000, 0, "vector"), (5, 54_784, 0, "vector"),
             (7, 8 * 1000 + 3, 0, "per_element"), (1, 5, 0, "per_element"),
             (2, 8 * 1000, 1, "per_element"), (3, 8 * 999, 1, "per_element")]
    for K, N, off, design in cases:
        pb = torch.randn(N + off, device=dev, generator=g).to(dt)
        sb = torch.randn(K * N + off, device=dev, generator=g).to(dt)
        prev, stacked = pb[off:], sb[off:].view(K, N)
        sizes = torch.rand(K, device=dev, generator=g) + 0.5
        keep = (torch.rand(K, device=dev, generator=g) < 0.7).float()
        keep[0] = 1.0
        for t in (7.0, 400.0):      # alpha on its schedule and at its cap
            coefs = torch.tensor([0.1, 2.5e-3, 0.95, t], device=dev)
            before = tsp.server_mix_designs()
            got = tsp.server_mix_flat(prev, stacked, sizes, keep, coefs)
            after = tsp.server_mix_designs()
            moved = {d: after[d] - before[d] for d in after}
            assert moved == {d: int(d == design) for d in moved}, (K, N, off)
            want = tref.server_mix_math(prev, stacked, sizes, keep, coefs)
            assert torch.equal(got, want), (K, N, off, t)


#: the paper CNN's 8 leaves in tree order
CNN_LEAVES = (250, 5000, 120, 38400, 84, 10080, 10, 840)


def _leaves(dev, g, sizes, pdts, sdts, K, offset=()):
    """prevs and stackeds of the given sizes and dtypes; the leaves in
    ``offset`` start one element past an aligned base."""
    prevs, stackeds = [], []
    for j, (n, pdt, sdt) in enumerate(zip(sizes, pdts, sdts)):
        o = int(j in offset)
        prevs.append(torch.randn(n + o, device=dev, generator=g).to(pdt)[o:])
        stackeds.append(torch.randn(K * n + o, device=dev,
                                    generator=g).to(sdt)[o:].view(K, n))
    return prevs, stackeds


@pytest.mark.gpu
def test_ama_mix_leaves_equals_plain_on_card():
    """ama_mix_leaves against ama_mix_leaves_math on the card, bit for
    bit: the CNN's 8 leaves in 1 launch (f32, bf16, and K = 2 f32 rows
    under bf16 prev), 100 leaves in 2 (the table holds 64), two dtype
    pairs in 2, a leaf offset by one element on the per-element path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.ama_mix import ama_mix_leaves, leaf_launches
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(CNN_LEAVES, [f32] * 8, [f32] * 8, 1, (), 1),
             (CNN_LEAVES, [bf16] * 8, [bf16] * 8, 1, (), 1),
             (CNN_LEAVES, [bf16] * 8, [f32] * 8, 2, (), 1),
             ([5 + 37 * j for j in range(100)], [f32] * 100, [f32] * 100, 1,
              (), 2),
             (CNN_LEAVES, [f32, bf16] * 4, [f32, bf16] * 4, 2, (), 2),
             ((5000, 38400, 840), [f32] * 3, [f32] * 3, 2, (1,), 1)]
    for sizes, pdts, sdts, K, offset, launches in cases:
        prevs, stackeds = _leaves(dev, g, sizes, pdts, sdts, K, offset)
        alpha = torch.rand(1, device=dev, generator=g)
        w = torch.rand(K, device=dev, generator=g)
        tsp.reset_counts()
        got = ama_mix_leaves(prevs, stackeds, alpha, w)
        assert ama_mix_leaves.launches == launches, (len(sizes), K)
        want = tref.ama_mix_leaves_math(prevs, stackeds, alpha, w)
        for j, (a, b) in enumerate(zip(got, want, strict=True)):
            assert a.dtype == b.dtype and torch.equal(a, b), (sizes[j], K)
        if offset:
            (plan,) = leaf_launches(prevs, stackeds, got)
            assert plan.vec == (True, False, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_server_async_vector_and_per_element_kernels_bitwise(dt):
    """server_async takes its 16-byte kernel where K <= 8, N is a
    multiple of the vector and every operand is 16-byte aligned, and its
    per-element kernel otherwise; over two wraps of the ring, with a
    round where nobody is on time, the two equal each other and the
    plain version bit for bit (the per-element run reads prev from a
    base offset by one element), and the design counts show which ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    hyp = torch.tensor([0.1, 2.5e-3, 0.95, 0.6], device=dev)
    for K, Q, N in ((5, 11, 54_784), (2, 3, 8 * 1000), (8, 5, 8 * 999),
                    (1, 1, 64)):
        prev = torch.randn(N, device=dev, generator=g).to(dt)
        qsum = torch.zeros(Q, N, device=dev)
        qgamma = torch.zeros(Q, device=dev)
        sizes = torch.rand(K, device=dev, generator=g) + 0.5
        for t in range(2 * Q + 1):
            stacked = (prev.float()[None] + 0.1 * torch.randn(
                K, N, device=dev, generator=g)).to(dt)
            delayed = (torch.rand(K, device=dev, generator=g) < 0.4).float()
            if t == 1:
                delayed.fill_(1.0)      # nobody on time
            delays = torch.randint(1, max(Q - 1, 1) + 1, (K,), device=dev,
                                   generator=g, dtype=torch.int32)
            tq = torch.tensor([t, t % Q], device=dev, dtype=torch.int32)
            rest = (qsum, qgamma, sizes, delayed, delays, tq, hyp)
            shifted = torch.empty(N + 1, device=dev, dtype=dt)[1:]
            shifted.copy_(prev)
            outs = {}
            for design, p in (("vector", prev), ("per_element", shifted)):
                before = tsp.server_async_designs()
                outs[design] = tsp.server_async_flat(p, stacked, *rest)
                after = tsp.server_async_designs()
                assert {d: after[d] - before[d] for d in after} == {
                    d: int(d == design) for d in after}, (K, Q, N, t)
            want = tref.server_async_math(prev, stacked, *rest)
            for got in outs.values():
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    K, Q, N, t)
            prev, qsum, qgamma = want


@pytest.mark.gpu
def test_server_adam_and_delta_vector_and_per_element_kernels_bitwise():
    """server_adam and server_mix_delta take their 16-byte kernels where N
    is a multiple of the 16-byte unit (prev's vector for server_adam; 16
    bytes of the narrower of prev and the rows for server_mix_delta: 16
    elements under int8 rows) and every operand is 16-byte aligned, and
    their per-element kernels otherwise (N + 1, prev offset by one
    element); the design counts show which ran, and every call equals
    the plain version bit for bit: K 1, 5 and 10 (two row batches), f32
    and bf16 prev, int8 / bf16 / f32 rows, nobody kept, steps 1 and 37."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def layouts(N):
        # (N, element offset of prev, the kernel expected)
        return ((N, 0, "vector"), (N + 1, 0, "per_element"),
                (N, 1, "per_element"))

    def taken(read, fn):
        before = read()
        out = fn()
        after = read()
        return out, [d for d in after if after[d] != before[d]]

    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 7.0], device=dev)
    for K in (1, 5, 10):
        for kept in (True, False):
            sizes = torch.rand(K, device=dev, generator=g) + 0.5
            keep = (torch.rand(K, device=dev, generator=g) < 0.7).float()
            keep[0] = 1.0
            keep *= float(kept)
            for dt in (f32, bf16):
                for N0, off, design in layouts(16 * 1000):
                    pb = torch.randn(N0 + off, device=dev, generator=g)
                    prev = pb.to(dt)[off:]
                    N = prev.shape[0]
                    m = 1e-3 * torch.randn(N, device=dev, generator=g)
                    v = 1e-6 * torch.rand(N, device=dev, generator=g)
                    stacked = (prev.float()[None] + 0.01 * torch.randn(
                        K, N, device=dev, generator=g)).to(dt)
                    for step in (1.0, 37.0):
                        sc = torch.tensor([0.9, 0.99, 0.1, 1e-3, step],
                                          device=dev)
                        args = (prev, stacked, m, v, sizes, keep, sc)
                        got, moved = taken(tsp.server_adam_designs,
                                           lambda: tsp.server_adam_flat(*args))
                        assert moved == [design], (K, N, off, dt)
                        want = tref.server_adam_math(*args)
                        assert all(torch.equal(a, b)
                                   for a, b in zip(got, want)), (K, N, off,
                                                                 dt, step)
                    for rt in (i8, bf16, f32):
                        if rt == i8:
                            rows = torch.randint(-127, 128, (K, N), device=dev,
                                                 generator=g, dtype=i8)
                            rows[0, :2] = torch.tensor([-127, 127])
                            rs = torch.rand(K, device=dev, generator=g) * 1e-3
                        else:
                            rows = (0.01 * torch.randn(
                                K, N, device=dev, generator=g)).to(rt)
                            rs = torch.ones(K, device=dev)
                        args = (prev, rows, rs, sizes, keep, coefs)
                        got, moved = taken(
                            tsp.server_mix_delta_designs,
                            lambda: tsp.server_mix_delta_flat(*args))
                        assert moved == [design], (K, N, off, dt, rt)
                        assert torch.equal(
                            got, tref.server_mix_delta_math(*args)), (
                                K, N, off, dt, rt, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minitron-8b", "rwkv6-3b"])
def test_remat_pod_round_bitwise_on_card(arch):
    """One ama_fes pod round of the reduced arch in f32 on the card
    (flash or rwkv6 kernels, deterministic): params and losses with
    remat on == off, bit for bit; with remat the forward kernel runs
    twice a layer a local step, the backward kernels once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import env as tenv
    from repro_torch.configs.base import FLConfig, reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.exec.engine import ChunkRunner
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rwkv6_scan as trs
    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import leaves
    dev = resolve_device("cuda")
    km = trs if arch == "rwkv6-3b" else tfa
    fwd = "rwkv6_fwd" if arch == "rwkv6-3b" else "flash_fwd"
    fl = FLConfig(num_clients=2, clients_per_round=2, cohorts=2,
                  local_steps=2, p_limited=0.5, lr=0.1, algorithm="ama_fes",
                  seed=0)
    S = 128
    out = []
    for remat in (True, False):
        cfg = reduced(ARCHS[arch], dtype="float32").with_(remat=remat)
        toks = make_lm_tokens(4, S + 1, cfg.vocab_size, n_topics=2,
                              seed=0)["tokens"][:, :S].reshape(2, 2, 1, S)
        params = ttf.init_params(cfg, torch.Generator().manual_seed(0), dev)
        state = {"params": params, "t": torch.zeros((), dtype=torch.int32,
                                                     device=dev), "aux": {}}
        runner = ChunkRunner(build_model(cfg), fl, per_round_batch=False,
                             device=dev)
        km.reset_counts()
        state, m = runner.run_chunk(state, {"tokens": toks},
                                    tenv.resolve(fl).batch(0, 1))
        calls = fl.local_steps * cfg.num_layers
        for name, fn in km.KERNELS.items():
            assert fn.launches == (2 if remat and name == fwd else 1) * calls
        out.append((state, m))
    (a, ma), (b, mb) = out
    assert all(torch.equal(x, y) for x, y in zip(leaves(a["params"]),
                                                 leaves(b["params"]),
                                                 strict=True))
    assert list(ma["loss"]) == list(mb["loss"])


@pytest.mark.gpu
def test_zamba2_remat_pod_round_bitwise_on_card():
    """One ama_fes pod round of the reduced zamba2 at 6 layers (2
    shared-attention sites) in f32 on the card: params and losses with
    remat on == off, bit for bit; mamba2_fwd twice a layer a local step
    with remat, mamba2_bwd once, each flash kernel once a site a step
    (the shared attention is outside remat)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import env as tenv
    from repro_torch.configs.base import FLConfig, reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.exec.engine import ChunkRunner
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import mamba2_scan as tms
    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import leaves
    dev = resolve_device("cuda")
    fl = FLConfig(num_clients=2, clients_per_round=2, cohorts=2,
                  local_steps=2, p_limited=0.5, lr=0.1, algorithm="ama_fes",
                  seed=0)
    S = 128
    out = []
    for remat in (True, False):
        cfg = reduced(ARCHS["zamba2-1.2b"], dtype="float32",
                      num_layers=6).with_(remat=remat)
        toks = make_lm_tokens(4, S + 1, cfg.vocab_size, n_topics=2,
                              seed=0)["tokens"][:, :S].reshape(2, 2, 1, S)
        params = ttf.init_params(cfg, torch.Generator().manual_seed(0), dev)
        state = {"params": params, "t": torch.zeros((), dtype=torch.int32,
                                                     device=dev), "aux": {}}
        runner = ChunkRunner(build_model(cfg), fl, per_round_batch=False,
                             device=dev)
        tms.reset_counts()
        tfa.reset_counts()
        state, m = runner.run_chunk(state, {"tokens": toks},
                                    tenv.resolve(fl).batch(0, 1))
        steps = fl.local_steps
        assert tms.mamba2_fwd.launches == (2 if remat else 1) * 6 * steps
        assert tms.mamba2_bwd.launches == 6 * steps
        assert all(fn.launches == 2 * steps for fn in tfa.KERNELS.values())
        out.append((state, m))
    (a, ma), (b, mb) = out
    assert all(torch.equal(x, y) for x, y in zip(leaves(a["params"]),
                                                 leaves(b["params"]),
                                                 strict=True))
    assert list(ma["loss"]) == list(mb["loss"])


#: (dtype, B, c, window, H, KH, hd, ring, block size): decode and
#: prefill over a ring that has wrapped (window > 0) or a linear cache
#: (window 0, the last block unmapped when paged), GQA, pad rows
SERVE_CASES = [("bfloat16", 2, 1, 64, 8, 2, 128, 64, 16),
               ("bfloat16", 2, 8, 64, 8, 2, 128, 64, 16),
               ("bfloat16", 1, 16, 0, 4, 4, 64, 96, 8),
               ("float32", 3, 5, 32, 4, 2, 64, 32, 4),
               ("float32", 2, 1, 0, 6, 2, 96, 48, 16),
               # rings of several 256-slot spans: decode over a linear
               # cache whose later spans are empty (fully masked, the last
               # block unmapped when paged), 80 query rows of a kv head
               # (two row groups) under a window over a wrapped ring, f32
               # in 64-row groups, hd 32 in 8-row groups
               ("bfloat16", 2, 1, 0, 8, 2, 128, 640, 16),
               ("bfloat16", 2, 20, 300, 8, 2, 128, 528, 16),
               ("float32", 1, 9, 0, 4, 4, 64, 272, 16),
               ("bfloat16", 1, 3, 0, 8, 4, 32, 800, 16)]


def _serve_state(dev, g, dt, B, c, window, H, KH, hd, L, bs):
    """The cache before a chunk (each slot the latest position below the
    chunk's first, of its residue), the chunk (the last row's last two
    rows pad when c > 2) and the same cache as a pool under a shuffled
    table."""
    from repro_torch.kernels.ref import PAD_POS
    p0 = torch.tensor([(L + 9 if window else 3) + 5 * b for b in range(B)],
                      device=dev)
    s = torch.arange(L, device=dev)
    cpos = p0[:, None] - 1 - torch.remainder(p0[:, None] - 1 - s, L)
    cpos = torch.where(cpos >= 0, cpos, -1).to(torch.int32)
    rnd = lambda *sh: torch.randn(*sh, device=dev, generator=g).to(dt)
    ck, cv = rnd(B, L, KH, hd), rnd(B, L, KH, hd)
    q = rnd(B, c, H, hd) * hd ** -0.5
    k, v = rnd(B, c, KH, hd), rnd(B, c, KH, hd)
    pos = (p0[:, None] + torch.arange(c, device=dev)).to(torch.int32)
    if c > 2:
        pos[-1, -2:] = PAD_POS
    mb = L // bs
    table = (torch.randperm(B * mb, device=dev, generator=g) + 1).reshape(
        B, mb).to(torch.int32)
    if not window:
        table[:, -1] = 0
    nb = 1 + B * mb
    pk, pv = rnd(nb, bs, KH, hd), rnd(nb, bs, KH, hd)
    ppos = torch.full((nb, bs), 3, dtype=torch.int32, device=dev)
    keep = table.flatten() > 0
    idx = table.flatten()[keep].long()
    pk[idx] = ck.reshape(B * mb, bs, KH, hd)[keep]
    pv[idx] = cv.reshape(B * mb, bs, KH, hd)[keep]
    ppos[idx] = cpos.reshape(B * mb, bs)[keep]
    ring = torch.full((B,), L, dtype=torch.int32, device=dev)
    return (q, k, v, pos), (ck, cv, cpos), (pk, pv, ppos, table, ring)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,B,c,window,H,KH,hd,L,bs", SERVE_CASES)
def test_serve_attention_matches_plain_on_card(dt, B, c, window, H, KH, hd,
                                               L, bs):
    """serve_attention against its plain version under FlashAttention's
    rule (bf16: within twice the plain bf16 version's error against the
    plain version in f32, floor 1e-3 x max|want|; f32: atol 1e-5 + rtol
    1e-5); the paged pool bitwise equal to the dense cache; every row of
    the chunk bitwise equal to that row at c = 1 against the per-token
    loop's cache; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import serve_attention as tsa
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(5)
    chunk, dense, paged = _serve_state(dev, g, dtype, B, c, window, H, KH,
                                       hd, L, bs)
    tsa.reset_counts()
    got = tsa.serve_attention(*chunk, *dense, window=window)
    assert tsa.serve_attention.launches == 1
    assert torch.equal(got, tsa.serve_attention(*chunk, *paged,
                                                window=window))
    want = tref.serve_attention_ref(*chunk, *dense, window=window)
    f32 = [x.float() if x.is_floating_point() else x
           for x in (*chunk, *dense)]
    want32 = tref.serve_attention_ref(*f32, window=window)
    err = float((got.float() - want32).abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-5, atol=1e-5)
    else:
        own = float((want.float() - want32).abs().max())
        assert err <= max(2 * own, 1e-3 * float(want32.abs().max()))
    q, k, v, pos = chunk
    for i in range(c):
        ck, cv, cpos = (x.clone() for x in dense)
        for j in range(i):
            for b in range(B):
                if pos[b, j] < (1 << 29):
                    slot = int(pos[b, 0] + j) % L
                    ck[b, slot], cv[b, slot] = k[b, j], v[b, j]
                    cpos[b, slot] = pos[b, j]
        row = lambda x: x[:, i:i + 1].contiguous()
        one = tsa.serve_attention(row(q), row(k), row(v), row(pos), ck, cv,
                                  cpos, window=window)
        assert torch.equal(got[:, i], one[:, 0]), i


@pytest.mark.gpu
def test_serve_attention_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import serve_attention as tsa
    dev = torch.device("cuda")
    f = dict(device=dev)
    pos = torch.zeros(1, 1, dtype=torch.int32, **f)
    cpos = torch.zeros(1, 8, dtype=torch.int32, **f)
    for hd in (80, 16):            # not a head dim the kernel is built for
        x = torch.zeros(1, 1, 2, hd, **f)
        c = torch.zeros(1, 8, 2, hd, **f)
        with pytest.raises(ValueError, match="head dims"):
            tsa.serve_attention(x, x, x, pos, c, c, cpos)
    x = torch.zeros(1, 1, 2, 64, **f)
    c = torch.zeros(1, 8 * 64 * 2 + 1, **f)[:, 1:].reshape(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tsa.serve_attention(x, x, x, pos, c, c, cpos)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_serve_attention_masked_null_block_never_reaches_a_row(dt):
    """A paged pool whose null block (the unmapped last block of each row
    and the pad rows' trash) holds NaN gives, bit for bit, the dense
    cache's rows: a masked slot's value never enters a row that sees a
    slot, in a ring of three spans whose last two are empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import serve_attention as tsa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    chunk, dense, paged = _serve_state(dev, g, getattr(torch, dt), 2, 4, 0,
                                       8, 2, 64, 640, 16)
    pk, pv, ppos, table, ring = paged
    assert bool((table == 0).any())
    pk[0], pv[0] = float("nan"), float("nan")
    got = tsa.serve_attention(*chunk, *dense)
    assert torch.isfinite(got).all()
    assert torch.equal(got, tsa.serve_attention(*chunk, pk, pv, ppos, table,
                                                ring))


#: (dtype, B, c, H, KH, hd, L): serve_attention's cross form at decode
#: and at chunks of 8 and 64 rows, over whisper's 1,500 encoder keys (six
#: spans) and over one span, GQA
CROSS_CASES = [("bfloat16", 4, 1, 16, 16, 64, 1500),
               ("bfloat16", 2, 8, 16, 16, 64, 1500),
               ("float32", 2, 64, 4, 2, 64, 1500),
               ("bfloat16", 1, 5, 8, 4, 128, 200),
               ("float32", 3, 1, 6, 2, 96, 700)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt,B,c,H,KH,hd,L", CROSS_CASES)
def test_serve_cross_attention_matches_plain_on_card(dt, B, c, H, KH, hd,
                                                     L):
    """The cross form against its plain version under the self form's
    rule, every row of a chunk bitwise that row at c = 1, one launch a
    call on its own count; the self form's count untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import serve_attention as tsa
    dev, dtype = torch.device("cuda"), getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(L + c)
    q = (torch.randn(B, c, H, hd, device=dev, generator=g)
         * hd ** -0.5).to(dtype)
    ek, ev = (torch.randn(B, L, KH, hd, device=dev, generator=g).to(dtype)
              for _ in "kv")
    tsa.reset_counts()
    got = tsa.serve_cross_attention(q, ek, ev)
    assert (tsa.serve_cross_attention.launches,
            tsa.serve_attention.launches) == (1, 0)
    want = tref.serve_cross_attention_ref(q, ek, ev)
    want32 = tref.serve_cross_attention_ref(q.float(), ek.float(),
                                            ev.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-5, atol=1e-5)
    else:
        err = float((got.float() - want32).abs().max())
        own = float((want.float() - want32).abs().max())
        assert err <= max(2 * own, 1e-3 * float(want32.abs().max()))
    for i in range(c):
        one = tsa.serve_cross_attention(q[:, i:i + 1].contiguous(), ek, ev)
        assert torch.equal(got[:, i], one[:, 0]), i


@pytest.mark.gpu
def test_invariant_dense_padded_head_on_card():
    """whisper's lm_head (1024 x 51,865 bf16): refused as it is (its
    rows are not 16-byte multiples), carried padded to 51,872 zero
    columns by ``pad_columns``; the first 51,865 outputs within twice
    cuBLAS's error of the unpadded product, the rest exactly 0, and
    every row bitwise across M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    K, N = 1024, 51865
    x = torch.randn(65, K, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tid.invariant_dense(x, w)
    wp, _ = tid.pad_columns(w)
    assert wp.shape == (K, 51872) and tid.pad_columns(wp)[0] is wp
    full = tid.invariant_dense(x, wp)
    assert not full[:, N:].any()
    for M in (1, 4, 64):
        assert torch.equal(tid.invariant_dense(x[:M].contiguous(), wp),
                           full[:M]), M
    ref32 = x.float() @ w.float()
    err = float((full[:, :N].float() - ref32).abs().max())
    lib = float(((x @ w).float() - ref32).abs().max())
    assert err <= max(2 * lib, float(_ulp_bf16(ref32.abs().max())))


#: (K, N): a tile without a split, a ragged last n tile, minitron's wk/wv
#: shape (K split 8 ways), a split of 2 and one n tile
DENSE_SHAPES = [(256, 512), (1024, 136), (4096, 1024), (512, 64)]
#: the decode form up to 64 rows, the prefill forms above
DENSE_ROWS = (1, 4, 5, 64, 65, 128, 129, 130, 256, 260)


def _ulp_bf16(x):
    m, e = torch.frexp(x.abs().float().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(m), e - 8)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", DENSE_SHAPES)
def test_invariant_dense_rows_bitwise_across_m_on_card(K, N):
    """bf16 invariant_dense: every row bitwise the same whatever M (1 to
    260, and a 3-d input), one launch a call; within twice cuBLAS's error
    against the f32 product of the same bf16 operands (floor: one bf16
    ulp of max|ref|); with a bias, (x @ w) rounded then + b."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = torch.randn(260, K, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(
        torch.bfloat16)
    tid.reset_counts()
    full = tid.invariant_dense(x, w)
    for M in DENSE_ROWS:
        assert torch.equal(tid.invariant_dense(x[:M].contiguous(), w),
                           full[:M]), M
    assert torch.equal(tid.invariant_dense(x.reshape(2, 130, K), w),
                       full.reshape(2, 130, N))
    assert tid.invariant_dense.launches == len(DENSE_ROWS) + 2
    ref32 = x.float() @ w.float()
    err = float((full.float() - ref32).abs().max())
    lib = float(((x @ w).float() - ref32).abs().max())
    floor = float(_ulp_bf16(ref32.abs().max()))
    assert err <= max(2 * lib, floor), (err, lib, floor)
    b = torch.randn(N, device=dev, generator=g).to(torch.bfloat16)
    got = tid.invariant_dense(x, w, b)
    assert torch.equal(got, (full.float() + b.float()).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(4096, 1024), (1024, 136)])
def test_invariant_dense_forms_give_the_same_bits_on_card(K, N, monkeypatch):
    """Both prefill forms (128 and 256 rows a block) forced at M = 65, 256
    and 260 give the bits the wrapper's own choice gives, and those rows
    equal the decode form's at M = 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(K * N)
    x = torch.randn(260, K, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=dev, generator=g) * K ** -0.5).to(
        torch.bfloat16)
    want = {M: tid.invariant_dense(x[:M].contiguous(), w)
            for M in (64, 65, 256, 260)}
    for fm in (1, 2):
        monkeypatch.setattr(tid, "form", lambda M, K, Ns, sms, _f=fm:
                            0 if M <= tid.DECODE_ROWS else _f)
        tid._plan.cache_clear()
        for M in (65, 256, 260):
            got = tid.invariant_dense(x[:M].contiguous(), w)
            assert torch.equal(got, want[M]), (fm, M)
            assert torch.equal(got[:64], want[64]), (fm, M)
    tid._plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M", [1, 4, 64, 65, 256, 260])
def test_invariant_dense_group_equals_single_calls_on_card(M, bias):
    """A grouped call (minitron's wq|wk|wv shapes cut to K 1024 and a
    w_in|w_gate pair) is one launch, and each output equals that
    problem's single call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(M + bias)
    for K, Ns in ((1024, (1024, 256, 256)), (512, (2048, 2048))):
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        probs = [((torch.randn(K, N, device=dev, generator=g) * K ** -0.5
                   ).to(torch.bfloat16),
                  torch.randn(N, device=dev, generator=g).to(torch.bfloat16)
                  if bias else None) for N in Ns]
        tid.reset_counts()
        got = tid.invariant_dense_group(x, probs)
        assert tid.invariant_dense.launches == 1
        assert [tuple(y.shape) for y in got] == [(M, N) for N in Ns]
        for y, (w, b) in zip(got, probs):
            assert torch.equal(y, tid.invariant_dense(x, w, b))
        assert tid.invariant_dense.launches == 1 + len(Ns)
    xf = torch.randn(M, 256, device=dev, generator=g)
    wf = [torch.randn(256, N, device=dev, generator=g) / 16 for N in (136, 64)]
    tid.reset_counts()
    got = tid.invariant_dense_group(xf, [(w, None) for w in wf])
    assert tid.invariant_dense.launches == 1
    for y, w in zip(got, wf):
        assert torch.equal(y, tid.invariant_dense(xf, w))


@pytest.mark.gpu
def test_invariant_dense_group_refuses_what_one_launch_cannot_take():
    """A group whose problems disagree on K or dtype, or whose x (or a w)
    is not on a 16-byte boundary, raises; nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    x = torch.zeros(4, 64, **bf)
    w = torch.zeros(64, 64, **bf)
    tid.reset_counts()
    with pytest.raises(ValueError, match="shape"):
        tid.invariant_dense_group(x, [(w, None), (torch.zeros(128, 64, **bf),
                                                  None)])
    with pytest.raises(TypeError):
        tid.invariant_dense_group(x, [(w, None), (w.float(), None)])
    with pytest.raises(ValueError, match="16-byte"):
        xo = torch.zeros(4 * 64 + 1, **bf)[1:].reshape(4, 64)
        tid.invariant_dense_group(xo, [(w, None), (w, None)])
    with pytest.raises(ValueError, match="16-byte"):
        wo = torch.zeros(64 * 64 + 1, **bf)[1:].reshape(64, 64)
        tid.invariant_dense_group(x, [(w, None), (wo, None)])
    assert tid.invariant_dense.launches == 0


@pytest.mark.gpu
def test_invariant_dense_f32_rows_bitwise_on_card():
    """f32 invariant_dense (a warp a column on the CUDA cores, K in 32
    strided lanes and a fixed fold): rows bitwise across M, within 1e-5
    of the f64 product; N need not be a multiple of 8 in f32 (the MoE
    routers: N 16, 8 and the reduced configs' 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for K, N in ((256, 136), (4096, 16), (6144, 8), (256, 4)):
        x = torch.randn(70, K, device=dev, generator=g)
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        b = torch.randn(N, device=dev, generator=g)
        full = tid.invariant_dense(x, w, b)
        for M in (1, 4, 5, 9, 64, 70):
            assert torch.equal(tid.invariant_dense(x[:M].contiguous(), w, b),
                               full[:M]), (K, N, M)
        want = (x.double() @ w.double() + b.double()).float()
        torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_serve_rows_bitwise_on_card(dtype):
    """The MoE serving form on the card at reduced size (4 experts, top
    2): a row's output does not depend on the rows beside it (rows of a
    (3, 8) call bitwise the same rows called alone), 1 + E / 2 + E
    invariant_dense launches a call, and moe_apply_dense (cuBLAS) within
    the dtype's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import invariant_dense as tid
    from repro_torch.models import moe
    dev = torch.device("cuda")
    cfg = reduced(ARCHS["phi3.5-moe-42b-a6.6b"], dtype=dtype)
    dt = getattr(torch, dtype)
    p = moe.moe_init(torch.Generator(device=dev).manual_seed(5), cfg, dt)
    x = torch.randn(3, 8, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    x = x.to(dt)
    tid.reset_counts()
    full, _ = moe.moe_serve(p, cfg, x)
    E = cfg.num_experts
    assert tid.invariant_dense.launches == 1 + E // 2 + E
    for i in range(x.shape[1]):
        one, _ = moe.moe_serve(p, cfg, x[:, i:i + 1].contiguous())
        assert torch.equal(one, full[:, i:i + 1]), i
    want, _ = moe.moe_apply_dense(p, cfg, x)
    tol = dict(rtol=2e-2, atol=2e-2) if dt == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(full.float(), want.float(), **tol)


@pytest.mark.gpu
def test_invariant_dense_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_dense as tid
    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tid.invariant_dense(torch.zeros(4, 12, **bf), torch.zeros(12, 64, **bf))
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros(4 * 64 + 1, **bf)[1:].reshape(4, 64)
        tid.invariant_dense(x, torch.zeros(64, 64, **bf))
    with pytest.raises(ValueError, match="contiguous"):
        tid.invariant_dense(torch.zeros(64, 4, **bf).t(),
                            torch.zeros(64, 64, **bf))


@pytest.mark.gpu
@pytest.mark.parametrize("dt,d", [("bfloat16", 4096), ("bfloat16", 1000),
                                  ("float32", 256)])
def test_invariant_rmsnorm_rows_bitwise_across_m_on_card(dt, d):
    """invariant_rmsnorm: rows bitwise whatever M (1 to 260), within one
    ulp of the output dtype (bf16) or four (f32) of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_rmsnorm as tin
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(260, d, device=dev, generator=g).to(dtype)
    gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    tin.reset_counts()
    full = tin.invariant_rmsnorm(x, gain)
    for M in DENSE_ROWS:
        assert torch.equal(tin.invariant_rmsnorm(x[:M].contiguous(), gain),
                           full[:M]), M
    assert tin.invariant_rmsnorm.launches == len(DENSE_ROWS) + 1
    want = tref.invariant_rmsnorm_ref(x, gain)
    if dtype == torch.bfloat16:
        tol = _ulp_bf16(want)
    else:
        m, e = torch.frexp(want.abs().clamp(min=2.0 ** -126))
        tol = 4 * torch.ldexp(torch.ones_like(m), e - 24)
    assert bool(((full.float() - want.float()).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dt,d", [("bfloat16", 4096), ("bfloat16", 16384),
                                  ("float32", 256), ("bfloat16", 1000),
                                  ("bfloat16", 100)])
def test_invariant_add_rmsnorm_rows_bitwise_across_m_on_card(dt, d):
    """invariant_add_rmsnorm: s bitwise ``x + h``, y bitwise the norm-only
    form on s, rows bitwise whatever M (1 to 260), y within one ulp of the
    output dtype (bf16) or four (f32) of the plain version, one launch a
    call (d 100 takes the per-element form, d 16384 eight warps a row);
    an operand offset by one element (no 16-byte loads) gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import invariant_rmsnorm as tin
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(d + 1)
    x = torch.randn(260, d, device=dev, generator=g).to(dtype)
    h = torch.randn(260, d, device=dev, generator=g).to(dtype)
    gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    tin.reset_counts()
    s, y = tin.invariant_add_rmsnorm(x, h, gain)
    assert tin.invariant_add_rmsnorm.launches == 1
    assert torch.equal(s, x + h)
    assert torch.equal(y, tin.invariant_rmsnorm(s, gain))
    assert tin.invariant_rmsnorm.launches == 1
    for M in DENSE_ROWS:
        sm, ym = tin.invariant_add_rmsnorm(x[:M].contiguous(),
                                           h[:M].contiguous(), gain)
        assert torch.equal(sm, s[:M]) and torch.equal(ym, y[:M]), M
    assert tin.invariant_add_rmsnorm.launches == len(DENSE_ROWS) + 1
    buf = torch.empty(5 * d + 1, device=dev, dtype=dtype)[1:]
    xo = buf.view(5, d)
    xo.copy_(x[:5])
    so, yo = tin.invariant_add_rmsnorm(xo, h[:5].contiguous(), gain)
    assert torch.equal(so, s[:5]) and torch.equal(yo, y[:5])
    want_s, want = tref.invariant_add_rmsnorm_ref(x, h, gain)
    assert torch.equal(want_s, s)
    if dtype == torch.bfloat16:
        tol = _ulp_bf16(want)
    else:
        m, e = torch.frexp(want.abs().clamp(min=2.0 ** -126))
        tol = 4 * torch.ldexp(torch.ones_like(m), e - 24)
    assert bool(((y.float() - want.float()).abs() <= tol).all())
    warps, vpt, vec = tin.plan(d, dtype)
    assert vec == (d % (16 // x.element_size()) == 0)
    assert warps * 32 * vpt * (16 // x.element_size()) >= d
