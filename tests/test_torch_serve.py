"""The port's serving plane (repro_torch.serve, launch/serve.py and the
serving steps of the model API) on the CPU: the counterparts of the JAX
package's tests/test_serve_plane.py, held by the port itself, and the
port against the JAX package's engines and checkpoints.

The load-bearing contract is BIT-identity: chunked prefill and the paged
decode/prefill paths produce bitwise the same logits AND cache contents
as the per-token dense loop, so switching engines can never change
served tokens. On the CPU the bf16 projections are row-invariant and the
serving attention's plain version sums every row in slot order, so the
port holds it as the JAX package does (reduced configs are bf16).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.checkpoint.io import save_state as jsave_state
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro.serve import LoopEngine as JLoop
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.checkpoint.io import restore_params, save
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model
from repro_torch.obs.log import MetricsLogger, read_rows, validate_rows
from repro_torch.serve import (KVPool, LoopEngine, PagedEngine, Request,
                               Scheduler, latency_percentiles)
from repro_torch.utils.tree import leaves, params_from_numpy

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's ops on one intra-op thread: its many small ops
    slow down by orders of magnitude when several test workers' thread
    pools spin on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- fixtures
def _build(cfg):
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def dense():
    return _build(reduced(ARCHS["minitron-8b"]))


@pytest.fixture(scope="module")
def swa8():
    # window 8 < prompt lengths below -> the ring WRAPS during prefill
    return _build(reduced(ARCHS["minitron-8b"]).with_(sliding_window=8))


def _ids(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _prompts(cfg, B, P, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(1, cfg.vocab_size, (B, P)).astype(np.int32)


def _per_token(model, params, prompts, max_len):
    B, P = prompts.shape
    cache = model.init_decode_cache(params, B, max_len)
    outs = []
    for t in range(P):
        lg, cache = model.decode_step(params, _ids(prompts[:, t]),
                                      _ids(np.full((B,), t)), cache)
        outs.append(lg)
    return torch.stack(outs, 1), cache


def _chunked(model, params, prompts, max_len, c, pad_fill=0):
    B, P = prompts.shape
    cache = model.init_decode_cache(params, B, max_len)
    lgs = []
    for t0 in range(0, P, c):
        n = min(c, P - t0)
        toks = np.full((B, c), pad_fill, np.int32)
        poss = np.full((B, c), attn.PAD_POS, np.int32)
        toks[:, :n] = prompts[:, t0:t0 + n]
        poss[:, :n] = np.arange(t0, t0 + n)
        lg, cache = model.prefill(params, _ids(toks), _ids(poss), cache)
        lgs.append(lg[:, :n])
    return torch.cat(lgs, 1), cache


def _trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b),
                                                 strict=True))


# ------------------------------------------- chunked prefill bit-identity
@pytest.mark.parametrize("fix,c", [("dense", 4), ("swa8", 5)])
def test_prefill_bit_identical(fix, c, request):
    """Chunked prefill == per-token decode, bitwise, logits AND cache,
    incl. a ragged final chunk (P % c != 0) whose PAD tail must be inert,
    and (swa8) prompts that wrap the sliding-window ring."""
    model, params = request.getfixturevalue(fix)
    B, P, max_len = 2, 11, 20
    prompts = _prompts(model.cfg, B, P)
    ref_lg, ref_c = _per_token(model, params, prompts, max_len)
    blk_lg, blk_c = _chunked(model, params, prompts, max_len, c)
    assert torch.equal(ref_lg, blk_lg)
    assert _trees_equal(ref_c, blk_c)


def test_prefill_pad_garbage_inert(dense):
    """PAD positions are fully predicated: garbage token ids under PAD
    must not perturb logits or cache by a single bit."""
    model, params = dense
    prompts = _prompts(model.cfg, 2, 7)          # 7 % 3 != 0 -> PAD tail
    lg0, c0 = _chunked(model, params, prompts, 16, 3, pad_fill=0)
    lg1, c1 = _chunked(model, params, prompts, 16, 3,
                       pad_fill=model.cfg.vocab_size - 1)
    assert torch.equal(lg0, lg1)
    assert _trees_equal(c0, c1)


# ------------------------------------------------- paged vs dense parity
@pytest.mark.parametrize("fix", ["dense", "swa8"])
def test_paged_bit_identical_to_dense(fix, request):
    """Paged decode AND paged chunked prefill == the dense cache path,
    bitwise, when the block table covers the same ring (mb*bs == L)."""
    model, params = request.getfixturevalue(fix)
    cfg = model.cfg
    B, P, max_len, bs = 2, 12, 24, 4
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    mb = L // bs
    assert mb * bs == L
    prompts = _prompts(cfg, B, P)
    ref, _ = _per_token(model, params, prompts, max_len)

    nb = 1 + B * mb
    table = _ids(np.arange(1, nb, dtype=np.int32).reshape(B, mb))
    lw = _ids(np.full((B,), L))
    pool = model.init_paged_pool(nb, bs)
    outs = []
    for t in range(P):
        lg, pool = model.decode_step_paged(params, _ids(prompts[:, t]),
                                           _ids(np.full((B,), t)), pool,
                                           table, lw)
        outs.append(lg)
    assert torch.equal(ref, torch.stack(outs, 1))

    pool2 = model.init_paged_pool(nb, bs)
    c = 5
    lgs = []
    for t0 in range(0, P, c):
        n = min(c, P - t0)
        toks = np.zeros((B, c), np.int32)
        poss = np.full((B, c), attn.PAD_POS, np.int32)
        toks[:, :n] = prompts[:, t0:t0 + n]
        poss[:, :n] = np.arange(t0, t0 + n)
        lg, pool2 = model.prefill_paged(params, _ids(toks), _ids(poss),
                                        pool2, table, lw)
        lgs.append(lg[:, :n])
    assert torch.equal(ref, torch.cat(lgs, 1))
    assert _trees_equal(pool, pool2)     # same blocks written, same bits


# ------------------------------------------------- engines: e2e equality
def _mkreqs(vocab, lens, max_new, seed=1, cls=Request):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, max_new=max_new,
                prompt=rng.randint(1, vocab, (ln,)).tolist())
            for i, ln in enumerate(lens)]


def test_engines_serve_identical_tokens(dense):
    """loop(per-token) == loop(chunked prefill) == paged continuous
    batching, token for token, with more requests than slots, so the
    paged run exercises slot reuse and block recycling."""
    model, params = dense
    vocab = model.cfg.vocab_size
    lens, max_new = [5, 11, 8, 14], 6
    ra = LoopEngine(model, params).run(_mkreqs(vocab, lens, max_new))
    rb = LoopEngine(model, params, prefill_chunk=4).run(
        _mkreqs(vocab, lens, max_new))
    eng = PagedEngine(model, params, max_slots=2, block_size=4,
                      max_batch_tokens=64, prefill_chunk=4)
    rc = eng.run(_mkreqs(vocab, lens, max_new))
    for x, y, z in zip(ra, rb, rc):
        assert x["tokens"] == y["tokens"] == z["tokens"]
        assert x["new_tokens"] == max_new
    assert [r["id"] for r in rc] == list(range(len(lens)))


def test_loop_engine_pads_never_enter_cache(dense):
    """Variable-length prompts in the lockstep loop: each row's tokens
    match a solo run of that row."""
    model, params = dense
    vocab = model.cfg.vocab_size
    reqs = _mkreqs(vocab, [4, 9], 5)
    both = LoopEngine(model, params).run(_mkreqs(vocab, [4, 9], 5))
    for i, r in enumerate(reqs):
        solo = LoopEngine(model, params).run(
            [Request(rid=0, prompt=list(r.prompt), max_new=5)])
        assert solo[0]["tokens"] == both[i]["tokens"]


def test_paged_engine_checkpoint_restore_serves_identically(dense,
                                                            tmp_path):
    """Params through a save/restore round trip serve bit-identical
    tokens: serving a restored federated model is the product path."""
    model, params = dense
    path = str(tmp_path / "params.npz")
    save(path, params)
    back = restore_params(path, params)
    vocab = model.cfg.vocab_size
    r0 = PagedEngine(model, params, max_slots=2, block_size=4,
                     prefill_chunk=4).run(_mkreqs(vocab, [6, 13], 5))
    r1 = PagedEngine(model, back, max_slots=2, block_size=4,
                     prefill_chunk=4).run(_mkreqs(vocab, [6, 13], 5))
    assert [r["tokens"] for r in r0] == [r["tokens"] for r in r1]


def test_loop_engine_serves_recurrent_family():
    """The ssm family has no KV ring: LoopEngine per token serves it (on
    the rwkv6 recurrence at S = 1) and PagedEngine refuses it loudly."""
    model, params = _build(reduced(ARCHS["rwkv6-3b"]))
    out = LoopEngine(model, params).run(
        _mkreqs(model.cfg.vocab_size, [4, 7], 3))
    assert all(r["new_tokens"] == 3 for r in out)
    with pytest.raises(ValueError, match="no paged serving path"):
        PagedEngine(model, params)


# ------------------------------------------------- scheduler invariants
def test_scheduler_fifo_no_starvation_and_budget():
    # footprints (prompt + max_new): rid0=10, rid1=12, rid2=6, rid3=4
    s = Scheduler(max_batch_tokens=20)
    for i, (p, n) in enumerate([(6, 4), (8, 4), (4, 2), (2, 2)]):
        s.submit(Request(rid=i, prompt=[1] * p, max_new=n))

    def drain():
        out = []
        while True:
            r = s.try_admit(can_place=lambda r: True)
            if r is None:
                return out
            out.append(r)

    # rid0 fits; head rid1 would hit 22 > 20 -> blocked, and FIFO means
    # rid2 (which WOULD fit) must not jump the queue
    assert [r.rid for r in drain()] == [0]
    s.release(s.inflight[0])
    assert [r.rid for r in drain()] == [1, 2]
    s.release(s.inflight[2])
    assert [r.rid for r in drain()] == [3]
    assert s.admitted_order == s.submitted_order    # nobody overtaken
    assert s.peak_inflight_tokens <= 20


def test_scheduler_oversized_head_admitted_when_idle():
    """A request larger than the whole budget still runs (when nothing is
    in flight) rather than wedge the queue forever."""
    s = Scheduler(max_batch_tokens=8)
    s.submit(Request(rid=0, prompt=[1] * 20, max_new=4))
    r = s.try_admit(can_place=lambda r: True)
    assert r is not None and r.rid == 0


def test_paged_engine_scheduler_and_pool_invariants(dense):
    """After a full run: FIFO admission order, every slot reused, all
    blocks back on the free list, budget respected."""
    model, params = dense
    vocab = model.cfg.vocab_size
    eng = PagedEngine(model, params, max_slots=2, block_size=4,
                      max_batch_tokens=64, prefill_chunk=4)
    reqs = _mkreqs(vocab, [5, 11, 8, 14, 6], 4)
    out = eng.run(reqs)
    assert all(r["new_tokens"] == 4 for r in out)
    sched, kv = eng.scheduler, eng.kv
    assert sched.admitted_order == sched.submitted_order
    assert sched.peak_inflight_tokens <= 64
    assert sched.pending == 0 and not sched.inflight
    assert sum(len(v) for v in sched.slot_history.values()) == len(reqs)
    assert max(len(v) for v in sched.slot_history.values()) >= 3
    assert kv.free_blocks == kv.num_blocks - 1
    assert kv.used_blocks == 0


def test_paged_engine_rejects_unservable_request(dense):
    """A request whose ring cannot fit in the pool fails loudly instead
    of deadlocking the admission loop."""
    model, params = dense
    eng = PagedEngine(model, params, max_slots=1, block_size=4,
                      num_blocks=3, prefill_chunk=4)   # 2 usable blocks
    with pytest.raises(RuntimeError, match="blocks"):
        eng.run(_mkreqs(model.cfg.vocab_size, [20], 4))


def test_kv_pool_alloc_free_roundtrip(dense):
    model, _ = dense
    kv = KVPool(model, num_blocks=5, block_size=4)
    assert kv.free_blocks == 4                  # block 0 reserved
    got = kv.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert kv.used_blocks == 3 and not kv.can_alloc(2)
    for g in kv.pool.values():                  # as if written
        g["pos"][:, got] = 7
    kv.free(got)
    assert kv.free_blocks == 4
    # freeing resets the pos entries -> the kernel reads "unwritten"
    for g in kv.pool.values():
        assert bool(torch.all(g["pos"][:, got] == -1))


# ----------------------------------------------------- serve telemetry
def test_metrics_logger_serve_rows_validate(dense):
    model, params = dense
    eng = LoopEngine(model, params)
    results = eng.run(_mkreqs(model.cfg.vocab_size, [4, 7], 3))
    log = MetricsLogger(path=None)
    log.header(extra={"serve": {"engine": "loop"}})
    for r in results:
        log.serve(r)
    log.serve_summary(eng.last_summary)
    assert validate_rows(log.rows) == []
    serve_rows = [r for r in log.rows if r["kind"] == "serve"]
    assert len(serve_rows) == 2
    assert all("tokens" not in r for r in serve_rows)   # ids stay private
    assert [r["new_tokens"] for r in serve_rows] == [3, 3]


def test_latency_percentiles_shape():
    p = latency_percentiles([0.010, 0.020, 0.100])
    assert set(p) == {"p50_ms", "p95_ms", "p99_ms"}
    assert p["p50_ms"] == 20.0 and p["p95_ms"] <= p["p99_ms"]
    assert latency_percentiles([])["p50_ms"] is None


# ------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def f32_pair():
    """Reduced minitron-8b in f32 with JAX's params in both packages."""
    jcfg = jreduced(JARCHS["minitron-8b"], dtype="float32")
    jm = jbuild(jcfg)
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    tm = build_model(reduced(ARCHS["minitron-8b"], dtype="float32"))
    return jm, jp, tm, params_from_numpy(jp)


def test_served_tokens_match_jax_engines(f32_pair):
    """The port's three engines serve JAX's engines' tokens for the same
    params (reduced minitron-8b, f32; more requests than slots)."""
    jm, jp, tm, tp = f32_pair
    vocab, lens, max_new = jm.cfg.vocab_size, [5, 11, 8, 14, 6], 5
    want = [r["tokens"] for r in JPaged(
        jm, jp, max_slots=2, block_size=4, prefill_chunk=4).run(
        _mkreqs(vocab, lens, max_new, cls=JRequest))]
    assert want == [r["tokens"] for r in JLoop(jm, jp).run(
        _mkreqs(vocab, lens, max_new, cls=JRequest))]
    for eng in (LoopEngine(tm, tp), LoopEngine(tm, tp, prefill_chunk=4),
                PagedEngine(tm, tp, max_slots=2, block_size=4,
                            prefill_chunk=4)):
        assert [r["tokens"] for r in eng.run(
            _mkreqs(vocab, lens, max_new))] == want


def test_jax_round_state_checkpoint_serves_through_port(f32_pair,
                                                        tmp_path):
    """A {params, t, aux} round-state file written by the JAX package's
    save_state restores through the port's restore_params (params
    sliced at params/) and serves the tokens of the params themselves."""
    jm, jp, tm, tp = f32_pair
    path = str(tmp_path / "round.npz")
    jsave_state(path, {"params": jp, "t": np.int32(7),
                       "aux": {"ring": np.zeros((2, 3), np.float32)}})
    zero = jax.tree.map(lambda a: np.zeros_like(a), jp)
    back = restore_params(path, params_from_numpy(zero))
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tp)))
    reqs = lambda: _mkreqs(jm.cfg.vocab_size, [6, 13], 4)
    eng = lambda p: PagedEngine(tm, p, max_slots=2, block_size=4,
                                prefill_chunk=4)
    assert [r["tokens"] for r in eng(back).run(reqs())] == \
        [r["tokens"] for r in eng(tp).run(reqs())]


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_serve_launcher_runs_on_cpu_and_refuses_without_a_gpu(tmp_path):
    """``--device cpu --engine paged`` serves a prompt mix and writes
    valid serve rows; without --device, on a machine with no CUDA device,
    the launcher refuses (exit 2) instead of moving to the CPU."""
    out = str(tmp_path / "s.jsonl")
    proc = _run(["--arch", "minitron-8b", "--reduced", "--device", "cpu",
                 "--engine", "paged", "--prompt-mix", "6x2,20x2",
                 "--metrics-out", out])
    assert proc.returncode == 0, proc.stderr
    assert "engine=paged served 4 requests" in proc.stdout
    rows = read_rows(out)
    assert validate_rows(rows) == []
    assert [r["kind"] for r in rows].count("serve") == 4
    if torch.cuda.is_available():
        return
    proc = _run(["--arch", "minitron-8b", "--reduced"])
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr


def test_batched_decode_and_trace_requests(dense, tmp_path):
    """launch.serve's batched_decode gives each right-padded row its own
    length's tokens (the loop engine's); a --trace file's rows become
    requests (a prompt or a seeded prompt_len, max_new defaulting to
    --tokens)."""
    import json

    from repro_torch.launch import serve as tserve
    model, params = dense
    prompts = _prompts(model.cfg, 2, 9)
    out = tserve.batched_decode(model, params, prompts, 4, 16,
                                lengths=[5, 9])
    assert out.shape == (2, 13) and out.dtype == torch.int32
    for b, ln in enumerate((5, 9)):
        solo = LoopEngine(model, params).run(
            [Request(rid=0, prompt=prompts[b, :ln].tolist(), max_new=4)])
        assert out[b, 9:].tolist() == solo[0]["tokens"][ln:]
    path = tmp_path / "trace.jsonl"
    path.write_text(json.dumps({"id": 7, "prompt": [3, 4, 5]}) + "\n\n"
                    + json.dumps({"prompt_len": 6, "max_new": 2}) + "\n")
    args = tserve.parser().parse_args(["--trace", str(path), "--tokens",
                                       "5"])
    reqs = tserve.requests_of(args, model.cfg.vocab_size)
    assert [(r.rid, r.prompt_len, r.max_new) for r in reqs] == \
        [(7, 3, 5), (2, 6, 2)]
