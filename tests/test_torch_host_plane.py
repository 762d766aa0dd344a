"""The port's host plane (configs, env, data) against the JAX package's.

The port keeps its own numpy copies of these modules; schedules, synthetic
data, partitions and staged chunks must equal the JAX package's BITWISE,
so both packages train on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import env as jenv
from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.data.partition import shard_partition as jshard
from repro.data.pipeline import build_clients as jbuild
from repro.data.pipeline import stage_chunk as jstage
from repro.data.synth import make_image_classification as jmake
from repro_torch import env as tenv
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data.partition import shard_partition as tshard
from repro_torch.data.pipeline import build_clients as tbuild
from repro_torch.data.pipeline import stage_chunk as tstage
from repro_torch.data.synth import make_image_classification as tmake


def _assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cls", ["ModelConfig", "FLConfig"])
def test_config_fields_and_defaults_match(cls):
    fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jbase, cls))]
    ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tbase, cls))]
    assert fj == ft
    assert (dataclasses.asdict(TARCHS["paper-cnn"])
            == dataclasses.asdict(JARCHS["paper-cnn"]))


@pytest.mark.parametrize("p_delay,max_delay,population,K", [
    (0.0, 0, "auto", 20), (0.3, 5, "auto", 20), (0.3, 5, "virtual", 100_000)])
def test_bernoulli_schedule_bitwise(p_delay, max_delay, population, K):
    kw = dict(num_clients=K, clients_per_round=5, p_limited=0.5,
              p_delay=p_delay, max_delay=max_delay, population=population,
              seed=3)
    sizes = np.arange(K, dtype=np.float32) + 1.0
    je = jenv.resolve(jbase.FLConfig(**kw), data_sizes=sizes)
    te = tenv.resolve(tbase.FLConfig(**kw), data_sizes=sizes)
    a, b = je.batch(4, 7), te.batch(4, 7)
    _assert_dicts_equal(a, b)
    r = te.round(6)                        # batch row i == round(t0 + i)
    np.testing.assert_array_equal(r.selected, b["selected"][2])
    np.testing.assert_array_equal(r.delays, b["delays"][2])
    if max_delay:
        assert b["delayed"].any()


def test_synth_partition_and_staging_bitwise():
    jtrain, jtest = jmake(n_train=300, n_test=50, seed=1)
    ttrain, ttest = tmake(n_train=300, n_test=50, seed=1)
    _assert_dicts_equal(jtrain, ttrain)
    _assert_dicts_equal(jtest, ttest)
    jp = jshard(jtrain["label"], 10, seed=1)
    tp = tshard(ttrain["label"], 10, seed=1)
    assert len(jp) == len(tp) == 10
    for x, y in zip(jp, tp):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    selected = np.array([[0, 3, 7], [9, 1, 2]], np.int32)
    a = jstage(jtrain, jbuild(jtrain, jp), selected, 1, 5, 4, 6)
    b = tstage(ttrain, tbuild(ttrain, tp), selected, 1, 5, 4, 6)
    _assert_dicts_equal(a, b)
    assert b["image"].shape == (2, 3, 4, 6, 28, 28, 1)
    # row i of a chunk == staging round t0 + i alone
    c = tstage(ttrain, tbuild(ttrain, tp), selected[1:], 1, 6, 4, 6)
    _assert_dicts_equal({k: v[1:] for k, v in b.items()}, c)
