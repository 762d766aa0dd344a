"""The chunk-parallel forward algebra of the RWKV-6 forward kernel
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

_L = tref.RWKV6_CKPT


def _segments(x, n_seg, fill):
    """(B, S, H, hd) -> (B, H, NC, L, hd), a ragged last segment padded
    with ``fill`` (steps that change nothing: r = k = v = dy = 0, w = 1)."""
    B, S_, H, hd = x.shape
    pad = x.new_full((B, n_seg * _L - S_, H, hd), fill)
    return torch.cat([x, pad], 1).reshape(B, n_seg, _L, H, hd).permute(
        0, 3, 1, 2, 4)


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


# The forward kernel's algebra (csrc/rwkv6_scan.cu: a scan of the state
# over segment boundaries with suffix decay products, then every segment's
# y from its entering state in matrix form with prefix and pair decay
# products), mirrored the same way.

def _mirror_fwd_scan(k, v, w, s0):
    """Boundary scan: the state entering each segment (s0 first) and
    s_final, S_{c+1} = diag(W_c) S_c + sum_t diag(Q_t) k_t^T v_t, with Q_t
    the running product of w after t, taken from the segment's end, and
    W_c = prod_t w_t."""
    S, states = s0, []
    for c in range(w.shape[2]):
        states.append(S)
        q = torch.ones_like(w[:, :, c, 0])
        acc = torch.zeros_like(S)
        for t in reversed(range(_L)):
            acc = acc + (k[:, :, c, t] * q)[..., :, None] * v[:, :, c, t,
                                                              None, :]
            q = q * w[:, :, c, t]
        S = q[..., None] * S + acc
    return torch.stack(states, 2), S


def _mirror_fwd_segments(r, k, v, w, u, states):
    """y of every segment from its entering state: (r_t P_t) S_c + sum_s
    A[t][s] v_s, with P_t the running product of w before t, A[t][s] =
    sum_i r_t k_s D(s, t) for s < t (D(s, t) = prod_{s<rho<t} w_rho, a
    running product) and A[t][t] = sum_i r_t u k_t (the bonus)."""
    p = torch.ones_like(w[..., 0, :])
    rp = torch.empty_like(r)
    for t in range(_L):
        rp[..., t, :] = r[..., t, :] * p
        p = p * w[..., t, :]
    a = r.new_zeros(*r.shape[:3], _L, _L)
    for s in range(_L):
        a[..., s, s] = (r[..., s, :] * u[:, :, None, :] * k[..., s, :]).sum(-1)
        e = torch.ones_like(w[..., 0, :])
        for t in range(s + 1, _L):
            a[..., t, s] = (k[..., s, :] * e * r[..., t, :]).sum(-1)
            e = e * w[..., t, :]
    return (torch.einsum("bhcti,bhcij->bhctj", rp, states)
            + torch.einsum("bhcts,bhcsj->bhctj", a, v))


def _mirror_fwd(r, k, v, w, u, s0):
    """Both steps end to end, with rwkv6_scan_ref's signature and
    outputs."""
    B, S_, H, hd = r.shape
    n_seg = -(-S_ // _L)
    r_, k_, v_ = (_segments(x, n_seg, 0.0) for x in (r, k, v))
    w_ = _segments(w, n_seg, 1.0)
    states, s_final = _mirror_fwd_scan(k_, v_, w_, s0)
    y = _mirror_fwd_segments(r_, k_, v_, w_, u, states)
    return (y.permute(0, 2, 3, 1, 4).reshape(B, n_seg * _L, H, hd)[:, :S_],
            s_final, states)


@pytest.mark.parametrize("decay", ["model", "near 0", "near 1"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S_", [16, 100, 2048])
def test_chunk_parallel_forward_algebra_matches_plain(S_, hd, decay):
    """The mirror of the forward kernel's two steps against
    rwkv6_scan_ref on the same inputs, y, s_final and the saved states:
    in f64 within rtol 1e-5, atol 1e-6, and in f32 within the card's
    rule, 1e-5 x (1 + max |plain|)."""
    r, k, v, w, u, s0, _, _ = _decay_inputs(S_ + hd + 1, 1, S_, 2, hd, decay)
    for dtype in (torch.float64, torch.float32):
        args = [torch.tensor(a, dtype=dtype) for a in (r, k, v, w, u, s0)]
        want = tref.rwkv6_scan_ref(*args)
        got = _mirror_fwd(*args)
        for name, a, b in zip(("y", "s_final", "states"), got, want,
                              strict=True):
            assert a.shape == b.shape, name
            if dtype == torch.float64:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                           msg=name)
            else:
                err = float((a - b).abs().max())
                assert err <= 1e-5 * (1 + float(b.abs().max())), (name, err)
