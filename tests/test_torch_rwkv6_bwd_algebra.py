"""The chunk-parallel backward algebra of the RWKV-6 backward kernel
(csrc/rwkv6_scan.cu), mirrored in plain PyTorch and held against the
step-by-step plain version (repro_torch.kernels.ref) on the CPU. Moved
out of tests/test_torch_rwkv6.py unchanged so that the test runner's
workers take these long cases apart from the rest of that file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's ops on one intra-op thread: the mirror's many
    small ops slow down by orders of magnitude when several test workers'
    thread pools spin on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The backward kernel's algebra (csrc/rwkv6_scan.cu: the chunk-parallel
# form's three steps, segment sums, boundary scan and segment outputs; its
# first launch fuses the first two), mirrored in plain PyTorch over every
# segment at once. The CUDA code runs only on the card; this mirror holds
# its algebra against the step-by-step adjoint recurrence here. Shapes:
# (B, H, NC, L, hd) for a segmented (B, S, H, hd) input, L = RWKV6_CKPT.

_L = tref.RWKV6_CKPT


def _segments(x, n_seg, fill):
    """(B, S, H, hd) -> (B, H, NC, L, hd), a ragged last segment padded
    with ``fill`` (steps that change nothing: r = k = v = dy = 0, w = 1)."""
    B, S_, H, hd = x.shape
    pad = x.new_full((B, n_seg * _L - S_, H, hd), fill)
    return torch.cat([x, pad], 1).reshape(B, n_seg, _L, H, hd).permute(
        0, 3, 1, 2, 4)


def _mirror_sums(r, k, v, w, dy):
    """Segment sums: Delta = sum_t P_t r_t^T dy_t with P_t the running
    product of w before t, W = prod_t w_t, du's part sum_t r_t k_t (dy_t .
    v_t)."""
    p = torch.ones_like(w[..., 0, :])
    delta = p.new_zeros(*p.shape, p.shape[-1])
    du = torch.zeros_like(p)
    for t in range(_L):
        delta = delta + (p * r[..., t, :])[..., :, None] * dy[..., t, None, :]
        dyv = (dy[..., t, :] * v[..., t, :]).sum(-1, keepdim=True)
        du = du + r[..., t, :] * k[..., t, :] * dyv
        p = p * w[..., t, :]
    return delta, p, du


def _mirror_scan(delta, wprod, du_part, ds):
    """Boundary scan: the adjoint leaving each segment, last first from
    d(s_final); du over the segments; ds0."""
    G, ge = ds, torch.empty_like(delta)
    du = torch.zeros_like(du_part[:, :, 0])
    for c in reversed(range(delta.shape[2])):
        ge[:, :, c] = G
        G = wprod[:, :, c, :, None] * G + delta[:, :, c]
        du = du + du_part[:, :, c]
    return ge, du, G


def _mirror_segments(r, k, v, w, dy, u, s0, ge):
    """Segment outputs: dr, dk, dv, dw of every segment from its entering
    state s0 and the adjoint ge leaving it, by the kernel's matrix form;
    every decay product D(a, b) = prod_{a<rho<b} w_rho a running
    product."""
    ui = u[:, :, None, :]
    sd = torch.einsum("bhcij,bhctj->bhcti", s0, dy)
    gv = torch.einsum("bhcij,bhctj->bhcti", ge, v)
    q = torch.ones_like(w)
    for t in range(_L - 2, -1, -1):
        q[..., t, :] = q[..., t + 1, :] * w[..., t + 1, :]
    kg = torch.einsum("bhcti,bhcij->bhctj", k * q, ge)
    gs = (ge * s0).sum(-1)
    vd = torch.einsum("bhctj,bhcsj->bhcts", v, dy)   # v_tau . dy_sigma
    cc = (r * ui[:, :, :, None] * k).sum(-1)
    a_ts = torch.zeros_like(vd)
    for t in range(_L):
        e = torch.ones_like(w[..., 0, :])
        for sg in range(t + 1, _L):
            a_ts[..., t, sg] = (k[..., t, :] * e * r[..., sg, :]).sum(-1)
            e = e * w[..., sg, :]
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    for t in range(_L):
        d, s_r, s_g, alpha = torch.ones_like(gs), 0.0, 0.0, {}
        for ta in range(t - 1, -1, -1):
            alpha[ta] = d * k[..., ta, :]
            s_r = s_r + alpha[ta] * vd[..., ta, t, None]
            s_g = s_g + alpha[ta] * gv[..., ta, :]
            d = d * w[..., ta, :]
        e, s_k, s_s, cross = torch.ones_like(gs), 0.0, 0.0, 0.0
        for sg in range(t + 1, _L):
            b = e * r[..., sg, :]
            s_k = s_k + b * vd[..., t, sg, None]
            s_s = s_s + b * sd[..., sg, :]
            inner = sum((alpha[ta] * vd[..., ta, sg, None] for ta in range(t)),
                        torch.zeros_like(gs))
            cross = cross + b * inner
            e = e * w[..., sg, :]
        dyv = vd[..., t, t, None]
        dr[..., t, :] = d * sd[..., t, :] + s_r + ui * k[..., t, :] * dyv
        dk[..., t, :] = r[..., t, :] * ui * dyv + e * gv[..., t, :] + s_k
        dw[..., t, :] = e * d * gs + e * s_g + d * s_s + cross
        dv[..., t, :] = cc[..., t, None] * dy[..., t, :] + kg[..., t, :] + sum(
            (a_ts[..., t, sg, None] * dy[..., sg, :] for sg in range(t + 1, _L)),
            torch.zeros_like(gs))
    return dr, dk, dv, dw


def _mirror_bwd(dy, ds, r, k, v, w, u, states):
    """The three steps end to end, with rwkv6_scan_bwd_ref's signature
    and outputs."""
    B, S_, H, hd = r.shape
    n_seg = states.shape[2]
    r_, k_, v_, dy_ = (_segments(x, n_seg, 0.0) for x in (r, k, v, dy))
    w_ = _segments(w, n_seg, 1.0)
    ge, du, ds0 = _mirror_scan(*_mirror_sums(r_, k_, v_, w_, dy_), ds)
    outs = _mirror_segments(r_, k_, v_, w_, dy_, u, states, ge)
    return (*(o.permute(0, 2, 3, 1, 4).reshape(B, n_seg * _L, H, hd)[:, :S_]
              for o in outs), du, ds0)


def _decay_inputs(seed, B, S_, H, hd, decay):
    """r, k, v, w, u (per row), s0, dy, ds as chip_smoke.py draws them:
    decays over the model's range exp(-exp([-8, 4])), all near 0
    (~2e-24) or all 0.99966; f64 numpy."""
    rng = np.random.RandomState(seed)
    r, k, v, dy = (0.5 * rng.randn(B, S_, H, hd) for _ in range(4))
    z = rng.rand(B, S_, H, hd)
    w = {"model": lambda: np.exp(-np.exp(12.0 * z - 8.0)),
         "near 0": lambda: np.exp(-np.exp(3.9 + 0.1 * z)),
         "near 1": lambda: np.full_like(z, np.exp(-np.exp(-8.0)))}[decay]()
    u = 0.1 * rng.randn(B, H, hd)
    s0, ds = (0.1 * rng.randn(B, H, hd, hd) for _ in range(2))
    return r, k, v, w, u, s0, dy, ds


@pytest.mark.parametrize("decay", ["model", "near 0", "near 1"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S_", [16, 100, 2048])
def test_chunk_parallel_backward_algebra_matches_plain(S_, hd, decay):
    """The mirror of the backward kernel's three steps against
    rwkv6_scan_bwd_ref on the same inputs: in f64 within rtol 1e-5, atol
    1e-6 (the algebra: the two differ only by rounding, ~1e-15), and in
    f32 within the card's rule, 1e-5 x (1 + max |plain|) (f32 sums in
    another order; elementwise, cancellation puts single f32 elements
    beyond rtol 1e-5 of either order)."""
    x = _decay_inputs(S_ + hd, 1, S_, 2, hd, decay)
    for dtype in (torch.float64, torch.float32):
        r, k, v, w, u, s0, dy, ds = (torch.tensor(a, dtype=dtype) for a in x)
        _, _, states = tref.rwkv6_scan_ref(r, k, v, w, u, s0)
        want = tref.rwkv6_scan_bwd_ref(dy, ds, r, k, v, w, u, states)
        got = _mirror_bwd(dy, ds, r, k, v, w, u, states)
        for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                              want, strict=True):
            assert a.shape == b.shape, name
            if dtype == torch.float64:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                           msg=name)
            else:
                err = float((a - b).abs().max())
                assert err <= 1e-5 * (1 + float(b.abs().max())), (name, err)
