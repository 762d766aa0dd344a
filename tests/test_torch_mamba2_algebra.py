"""The chunked (SSD) algebra of the mamba2 kernels (csrc/mamba2_scan.cu),
forward and backward, mirrored in plain PyTorch and held against the
step-by-step plain versions (repro_torch.kernels.ref: mamba2_scan_ref,
mamba2_scan_bwd_ref) on the CPU: the chunks' own contributions, the scan
over chunk boundaries, the outputs from the entering states, the decay
products from the kernels' small tables and column walks (never a ratio
or a difference of logs), and da in four parts without dividing by a.
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


_L = tref.MAMBA2_CKPT
_Q = 16         # csrc/mamba2_scan.cu: kQ, steps a quarter of the tables


def _inputs(seed, B, S, H, P, N, decay, state):
    """a, xdt, B, C, h0, dy, dh, f64 numpy, drawn as chip_smoke.py draws
    them: a = exp(softplus(dt) A) (model), 1e-30 U(0, 1) (near 0), the
    model's with a fifth of the steps exactly 0 (zeros), or 1 and 0.9999
    at random steps (near 1); h0 and dh zero or not."""
    rng = np.random.RandomState(seed)
    dt_s = np.log1p(np.exp(rng.randn(B, S, H)))
    A = -np.exp(0.5 * rng.randn(H))
    a = {"model": lambda: np.exp(dt_s * A),
         "near 0": lambda: 1e-30 * rng.rand(B, S, H),
         "zeros": lambda: np.where(rng.rand(B, S, H) < 0.2, 0.0,
                                   np.exp(dt_s * A)),
         "near 1": lambda: np.where(rng.rand(B, S, H) < 0.5, 1.0,
                                    0.9999)}[decay]()
    xdt = rng.randn(B, S, H, P) * dt_s[..., None]
    Bm, Cm = (rng.randn(B, S, N) for _ in range(2))
    dy = 0.5 * rng.randn(B, S, H, P)
    scale = 0.3 if state == "nonzero" else 0.0
    h0, dh = (scale * rng.randn(B, H, P, N) for _ in range(2))
    return a, xdt, Bm, Cm, h0, dy, dh


def _chunks(x, nc):
    """(B, S, ...) -> (B, NC, L, ...), zeros past S."""
    pad = x.new_zeros((x.shape[0], nc * _L - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], 1).reshape(x.shape[0], nc, _L, *x.shape[2:])


def _prod(a, lo, hi):
    """a[..., lo] * ... * a[..., hi - 1] in step order (1 when empty)."""
    p = torch.ones_like(a[..., 0])
    for k in range(lo, hi):
        p = p * a[..., k]
    return p


def _decays(a, T):
    """The kernels' decay products of a chunk. a: (..., L), 0 past T.
    Tables: suf[j] = a_{j+1} ... a_{end of j's quarter} and each quarter
    multiplied whole; column j of Lm walked down each quarter q of rows
    from suf[j] times the whole quarters between, Lm[i][j] = Lm[i-1][j]
    a_i (1 at i = j, 0 above). Returns Lm (..., L, L), D (..., L) (D_i =
    a_0 Lm[i][0]), E (..., L) (E_t = Lm[T-1][t] for t < T, 0 above) and A
    (...) = D_{T-1}."""
    suf = torch.stack([_prod(a, j + 1, j - j % _Q + _Q) for j in range(_L)],
                      -1)
    quarter = torch.stack([_prod(a, b * _Q, (b + 1) * _Q)
                           for b in range(_L // _Q)], -1)
    lm = a.new_zeros((*a.shape, _L))
    for j in range(_L):
        for q in range(_L // _Q):
            p = suf[..., j]
            for b in range(j // _Q + 1, q):
                p = p * quarter[..., b]
            for i in range(q * _Q, (q + 1) * _Q):
                if i == j:
                    p = torch.ones_like(p)
                elif i > j:
                    p = p * a[..., i]
                if i >= j:
                    lm[..., i, j] = p
    D = a[..., :1] * lm[..., 0]
    E = torch.where(torch.arange(_L) < T, lm[..., T - 1, :], 0.0)
    return lm, D, E, D[..., T - 1]


def _chunk_setup(a, S):
    """Per chunk (B, H, NC, ...): Lm, D, E, A from a (B, S, H)."""
    nc = -(-S // _L)
    a_ = _chunks(a, nc).permute(0, 3, 1, 2)           # (B, H, NC, L)
    parts = [_decays(a_[:, :, c], min(_L, S - c * _L)) for c in range(nc)]
    return nc, [torch.stack(x, 2) for x in zip(*parts)]


def _mirror_fwd(a, xdt, Bm, Cm, h0):
    """mamba2_fwd's three launches: S_c = X^T diag(E) B, the scan h_{c+1}
    = A_c h_c + S_c, then Y = diag(D) (C h_c^T) + (Lm o C B^T) X."""
    B, S, H, P = xdt.shape
    nc, (lm, D, E, A) = _chunk_setup(a, S)
    X = _chunks(xdt, nc)                               # (B, NC, L, H, P)
    Bc, Cc = _chunks(Bm, nc), _chunks(Cm, nc)          # (B, NC, L, N)
    Sc = torch.einsum("bctn,bcthp,bhct->bhcpn", Bc, X, E)
    h, states = h0, []
    for c in range(nc):
        states.append(h)
        h = A[:, :, c, None, None] * h + Sc[:, :, c]
    states = torch.stack(states, 2)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = (torch.einsum("bhci,bcin,bhcpn->bcihp", D, Cc, states)
         + torch.einsum("bhcij,bcij,bcjhp->bcihp", lm, CB, X))
    return y.reshape(B, nc * _L, H, P)[:, :S], h, states


def _mirror_bwd(dy, dh, a, xdt, Bm, Cm, states):
    """mamba2_bwd's four launches: U_c = dY^T diag(D) C, the reverse scan
    R_{c-1} = A_c R_c + U_c from R = dh, then per chunk and head, with DX
    = dY X^T and W = Lm o DX: dX = diag(E) B R^T + (Lm o CB)^T dY, dC = W
    B + diag(D) dY h_c, dB = W^T C + diag(E) X R summed over the heads,
    and da in four parts (the kernel's header)."""
    B, S, H, P = xdt.shape
    nc, (lm, D, E, A) = _chunk_setup(a, S)
    X, dY = _chunks(xdt, nc), _chunks(dy, nc)
    Bc, Cc = _chunks(Bm, nc), _chunks(Cm, nc)
    U = torch.einsum("bctn,bcthp,bhct->bhcpn", Cc, dY, D)
    R, adj = dh, [None] * nc
    for c in reversed(range(nc)):
        adj[c] = R
        R = A[:, :, c, None, None] * R + U[:, :, c]
    adj = torch.stack(adj, 2)                          # (B, H, NC, P, N)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    DX = torch.einsum("bcihp,bcjhp->bhcij", dY, X)
    W = lm * DX
    Q = torch.einsum("bcihp,bhcpn->bhcin", dY, states)
    Z = torch.einsum("bcjhp,bhcpn->bhcjn", X, adj)
    q = torch.einsum("bhcin,bcin->bhci", Q, Cc)
    z = torch.einsum("bhcjn,bcjn->bhcj", Z, Bc)
    dC = (torch.einsum("bhcij,bcjn->bcin", W, Bc)
          + torch.einsum("bhci,bhcin->bcin", D, Q))
    dB = (torch.einsum("bhcij,bcin->bcjn", W, Cc)
          + torch.einsum("bhcj,bhcjn->bcjn", E, Z))
    dX = (torch.einsum("bhct,bctn,bhcpn->bcthp", E, Bc, adj)
          + torch.einsum("bhcit,bcit,bcihp->bcthp", lm, CB, dY))
    # L'[t][j] = Lm[t-1][j] (0 for t = 0); V = (DX o CB) L'^T
    lp = torch.cat([torch.zeros_like(lm[..., :1, :]), lm[..., :-1, :]], -2)
    V = torch.einsum("bhcij,bcij,bhctj->bhcit", DX, CB, lp)
    dm1 = torch.cat([torch.ones_like(D[..., :1]), D[..., :-1]], -1)
    hr = (adj * states).sum((-2, -1))[..., None]
    da = ((lm * V).sum(-2) + dm1 * torch.einsum("bhcit,bhci->bhct", lm, q)
          + E * torch.einsum("bhctj,bhcj->bhct", lp, z) + E * dm1 * hr)
    unchunk = lambda x: x.reshape(B, nc * _L, *x.shape[3:])[:, :S]
    return (unchunk(da.permute(0, 2, 3, 1)), unchunk(dX), unchunk(dB),
            unchunk(dC), R)


@pytest.mark.parametrize("state", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["model", "near 0", "zeros", "near 1"])
@pytest.mark.parametrize("S", [1, 17, 64, 100, 130])
def test_chunked_algebra_matches_plain(S, decay, state):
    """The mirror of both kernels' algebra against the plain forward and
    backward on the same inputs, every output (y, h_final, the states;
    da, dxdt, dB, dC, dh0): in f64 within rtol 1e-9, atol 1e-12 (the
    algebra is exact), and in f32 within the card's rule, 1e-5 x (1 + max
    |plain|). The backward runs on the plain states and, as on the pod
    path, on the mirror's own; nothing comes out NaN."""
    args = _inputs(S * 7 + len(decay) + len(state), 2, S, 3, 8, 16, decay,
                   state)
    for dtype in (torch.float64, torch.float32):
        a, xdt, Bm, Cm, h0, dy, dh = (torch.tensor(x, dtype=dtype)
                                      for x in args)
        want = tref.mamba2_scan_ref(a, xdt, Bm, Cm, h0)
        got = _mirror_fwd(a, xdt, Bm, Cm, h0)
        want += tref.mamba2_scan_bwd_ref(dy, dh, a, xdt, Bm, Cm, want[2])
        got += _mirror_bwd(dy, dh, a, xdt, Bm, Cm, want[2])
        own = _mirror_bwd(dy, dh, a, xdt, Bm, Cm, got[2])
        names = ("y", "h_final", "states", "da", "dxdt", "dB", "dC", "dh0")
        for name, u, v in zip(names + names[3:], got + own, want + want[3:],
                              strict=True):
            assert u.shape == v.shape, name
            assert torch.isfinite(u).all(), name
            if dtype == torch.float64:
                torch.testing.assert_close(u, v, rtol=1e-9, atol=1e-12,
                                           msg=name)
            else:
                err = float((u - v).abs().max())
                assert err <= 1e-5 * (1 + float(v.abs().max())), (name, err)


def test_decay_tables_have_no_ratio_or_log():
    """The table products stay exact where a ratio or a log difference
    fails: with exact zeros in a, every Lm entry whose range holds a zero
    is exactly 0, the rest equal the direct product, and nothing is NaN;
    a ratio of prefix products there is 0 / 0."""
    rng = np.random.RandomState(3)
    a = torch.tensor(rng.uniform(0.2, 1.0, (2, _L)))
    a[0, [5, 9, 40]] = 0.0
    a[1, 63] = 0.0
    lm, D, E, A = _decays(a, _L)
    assert torch.isfinite(lm).all() and torch.isfinite(D).all()
    for i in range(_L):
        for j in range(i + 1):
            want = _prod(a, j + 1, i + 1)
            assert torch.equal(lm[:, i, j] == 0, want == 0)
            torch.testing.assert_close(lm[:, i, j], want, rtol=1e-12,
                                       atol=0)
    torch.testing.assert_close(D, torch.cumprod(a, -1), rtol=1e-12, atol=0)
    torch.testing.assert_close(A, a.prod(-1), rtol=1e-12, atol=0)
    ratio = torch.cumprod(a, -1)[0, 20] / torch.cumprod(a, -1)[0, 10]
    assert torch.isnan(ratio)
    # a ragged chunk: E stops at T - 1 and is 0 above
    lm, D, E, A = _decays(torch.where(torch.arange(_L) < 37, a, 0.0), 37)
    torch.testing.assert_close(E[:, :37], torch.stack(
        [_prod(a, t + 1, 37) for t in range(37)], -1), rtol=1e-12, atol=0)
    assert (E[:, 37:] == 0).all()
