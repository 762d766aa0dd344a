"""The paper CNN in the port (repro_torch.models) against the JAX model.

Same params (carried across through numpy), same staged batch: logits,
loss and the gradient of the loss must agree. A crossed fc1 weight (the
NHWC-vs-NCHW flatten trap) would fail this by orders of magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.registry import ARCHS as JARCHS
from repro.core.fes import count_trainable as jcount
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients, stage_chunk
from repro.data.synth import make_image_classification
from repro.models.api import build_model as jbuild
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.fes import count_trainable as tcount
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy

# f32 on both sides; the convolutions and matmuls sum in different orders
# (XLA vs PyTorch CPU kernels), a few ulp per op over ~5 layers
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world():
    train, _ = make_image_classification(n_train=200, n_test=20, seed=0)
    clients = build_clients(train, shard_partition(train["label"], 4, seed=0))
    staged = stage_chunk(train, clients, np.array([[2]]), 0, 0, 1, 32)
    batch = {k: v[0, 0, 0] for k, v in staged.items()}    # (32, ...) batch
    jm, tm = jbuild(JARCHS["paper-cnn"]), tbuild(TARCHS["paper-cnn"])
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(jp), batch


def test_logits_loss_and_grads_match_jax(world):
    jm, tm, jp, tp, batch = world
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, _ = jm.forward(jp, batch)
    tl, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, batch)
    tg, tloss = torch.func.grad_and_value(tm.loss)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jgl = dict(flatten(jax.tree.map(np.asarray, jg)))
    for path, g in flatten(tg):
        np.testing.assert_allclose(g.numpy(), jgl[path], err_msg=path, **TOL)


def test_init_shapes_mask_and_trainable_count_match_jax(world):
    jm, tm, jp, _, _ = world
    tp = tm.init(torch.Generator().manual_seed(0))
    jflat = dict(flatten(jax.tree.map(np.asarray, jp)))
    for path, x in flatten(tp):
        assert tuple(x.shape) == jflat[path].shape, path
        assert x.dtype == torch.float32
    w = tp["fc1"]["w"]
    assert float(w.abs().max()) <= (1 / 320) ** 0.5
    assert float(tp["fc1"]["b"].abs().max()) == 0.0
    assert 0.08 < float(tp["body"]["conv2"]["w"].std()) < 0.12
    jmask, tmask = jm.fes_mask(jp), tm.fes_mask(tp)
    assert dict(flatten(tmask)) == dict(flatten(jmask))
    assert tcount(tp, tmask) == jcount(jp, jmask) == (49_534, 54_784)
