"""The CUDA server-plane kernels against their plain PyTorch versions on
the card. Marked ``gpu``: they skip on a machine without a CUDA device
(the kernels have no CPU mode). This file imports no JAX, so it runs on
the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
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
