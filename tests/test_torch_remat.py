"""``cfg.remat`` on the port's decoder stack (models/transformer.py:
``_BlockRemat``, the counterpart of JAX's ``jax.checkpoint`` around each
block) at reduced() size on the CPU.

Remat changes memory, not values: under ``vmap(grad_and_value)`` over 2
cohorts, as the client plane runs the loss, the loss and every gradient
are bitwise those of the stack without remat; so are the params after a
pod round. Between the forward and the backward only each block's input
is kept, and the block's forward (with its recurrence or attention
kernel's plain version here) runs twice a layer: once in the forward,
once in the recompute.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import grad_and_value, vmap

from repro_torch import env as tenv
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data.synth import make_lm_tokens as ttokens
from repro_torch.exec.engine import ChunkRunner as TRunner
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import leaves, tree_map

C, B, S = 2, 1, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's ops on one intra-op thread: the reduced LLMs'
    many small ops slow down by orders of magnitude when several test
    workers' thread pools spin on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: arch -> the plain versions of its forward and backward kernels
KERNEL_PLAINS = {"minitron-8b": ("flash_attention_ref",
                                 ("flash_bwd_dq_ref", "flash_bwd_dkdv_ref")),
                 "rwkv6-3b": ("rwkv6_scan_ref", ("rwkv6_scan_bwd_ref",))}


def _cfg(arch, dtype, remat, layers=2):
    return treduced(TARCHS[arch], dtype=dtype).with_(remat=remat,
                                                     num_layers=layers)


def _cohort_params_and_tokens(cfg, seed=0):
    """Two cohorts' params (the second a perturbation of the first) and
    tokens, from a numpy seed."""
    rng = np.random.default_rng(seed)
    p = ttf.init_params(cfg, torch.Generator().manual_seed(seed))

    def two(a):
        noise = torch.from_numpy(rng.standard_normal(a.shape,
                                                     dtype=np.float32))
        return torch.stack([a, (a.float() + 0.01 * noise).to(a.dtype)])

    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (C, B, S)))
    return tree_map(two, p), {"tokens": toks}


def _grads(cfg, params, batch):
    return vmap(grad_and_value(lambda p, b: ttf.loss_fn(p, cfg, b)))(params,
                                                                      batch)


@pytest.mark.parametrize("arch,dtype", [("minitron-8b", "float32"),
                                        ("minitron-8b", "bfloat16"),
                                        ("rwkv6-3b", "float32"),
                                        ("rwkv6-3b", "bfloat16")])
def test_remat_loss_and_every_gradient_bitwise(arch, dtype):
    """vmap(grad_and_value(loss)) over 2 cohorts, 3 layers (body and
    tail): remat on == off, bit for bit, loss and every gradient leaf."""
    on, off = (_cfg(arch, dtype, r, layers=3) for r in (True, False))
    params, batch = _cohort_params_and_tokens(on)
    g_on, l_on = _grads(on, params, batch)
    g_off, l_off = _grads(off, params, batch)
    assert l_on.shape == (C,) and bool(torch.isfinite(l_on).all())
    assert torch.equal(l_on, l_off)
    for a, b in zip(leaves(g_on), leaves(g_off), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(KERNEL_PLAINS))
def test_remat_runs_each_forward_kernel_twice_a_layer(arch, monkeypatch):
    """With remat the block's forward kernel (here its plain version,
    which the wrapper takes on the CPU) runs in the forward and again in
    the recompute: 2 calls a layer a vmapped step; the backward kernels
    once a layer. Without remat every kernel runs once a layer."""
    fwd, bwds = KERNEL_PLAINS[arch]
    calls = {}
    for name in (fwd, *bwds):
        orig = getattr(tref, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tref, name, counted)
    for remat in (True, False):
        cfg = _cfg(arch, "float32", remat)
        params, batch = _cohort_params_and_tokens(cfg)
        calls.clear()
        _grads(cfg, params, batch)
        L = cfg.num_layers
        assert calls == {fwd: (2 if remat else 1) * L,
                         **{b: L for b in bwds}}, (remat, calls)


@pytest.mark.parametrize("arch", sorted(KERNEL_PLAINS))
def test_remat_keeps_only_each_blocks_input(arch):
    """Tensors autograd saves in the forward (no vmap, one cohort): with
    remat every block input is among them, and together they hold less
    than a third of the bytes the stack without remat saves."""
    saved_bytes = {}
    for remat in (True, False):
        cfg = _cfg(arch, "float32", remat, layers=4)
        p = ttf.init_params(cfg, torch.Generator().manual_seed(0))
        param_ptrs = {x.untyped_storage().data_ptr() for x in leaves(p)}
        for x in leaves(p):
            x.requires_grad_(True)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)))
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in param_ptrs:
                seen[st.data_ptr()] = st.nbytes()
            return t

        inputs = []
        orig = ttf._BlockRemat.apply

        def spy(x, *rest):
            inputs.append(x.untyped_storage().data_ptr())
            return orig(x, *rest)
        ttf._BlockRemat.apply = spy
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = ttf.loss_fn(p, cfg, {"tokens": toks})
        finally:
            ttf._BlockRemat.apply = orig
        loss.backward()
        assert len(inputs) == (cfg.num_layers if remat else 0)
        assert all(ptr in seen for ptr in inputs)
        saved_bytes[remat] = sum(seen.values())
    assert saved_bytes[True] < saved_bytes[False] / 3, saved_bytes


def _peak_allocated(cfg, params, batch, trace):
    """Peak of the CPU allocator's live bytes over one vmapped
    grad_and_value (the memory events of a torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        g, loss = _grads(cfg, params, batch)
        del g, loss
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return max(e["args"]["Total Allocated"] for e in events
               if e.get("name") == "[memory]")


@pytest.mark.parametrize("arch", sorted(KERNEL_PLAINS))
def test_remat_lowers_peak_memory_under_vmap(arch, tmp_path):
    """Under vmap(grad_and_value) over 2 cohorts, as the client plane
    runs the loss, torch.func's backward keeps what it records to the
    end; with remat the peak is under half of the stack's without it at
    6 layers, and grows by under a quarter as much from 3 layers to 6
    (what grows with remat is mostly the layers' parameter gradients)."""
    peaks = {}
    for remat in (True, False):
        for layers in (3, 6):
            cfg = _cfg(arch, "float32", remat, layers=layers)
            params, _ = _cohort_params_and_tokens(cfg)
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (C, B, 256)))
            peaks[remat, layers] = _peak_allocated(
                cfg, params, {"tokens": toks}, tmp_path / "trace.json")
    assert peaks[True, 6] < peaks[False, 6] / 2, peaks
    assert (peaks[True, 6] - peaks[True, 3]
            < (peaks[False, 6] - peaks[False, 3]) / 4), peaks


@pytest.mark.parametrize("arch", sorted(KERNEL_PLAINS))
def test_remat_pod_round_bitwise(arch):
    """One ama_fes pod round of the reduced arch in f32 (2 cohorts, 2
    local steps, p_limited 0.5): params and losses with remat on == off,
    bit for bit."""
    fl = TFL(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
             p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0)
    out = []
    for remat in (True, False):
        cfg = _cfg(arch, "float32", remat)
        toks = ttokens(4, S + 1, cfg.vocab_size, n_topics=2,
                       seed=0)["tokens"][:, :S].reshape(2, 2, 1, S)
        state = {"params": ttf.init_params(cfg,
                                           torch.Generator().manual_seed(0)),
                 "t": torch.zeros((), dtype=torch.int32), "aux": {}}
        runner = TRunner(tbuild(cfg), fl, per_round_batch=False,
                         device="cpu")
        out.append(runner.run_chunk(state, {"tokens": toks},
                                    tenv.resolve(fl).batch(0, 1)))
    (a, ma), (b, mb) = out
    assert all(torch.equal(x, y) for x, y in zip(leaves(a["params"]),
                                                 leaves(b["params"]),
                                                 strict=True))
    np.testing.assert_array_equal(ma["loss"], mb["loss"])
    assert np.isfinite(ma["loss"]).all()
