"""Parameter trees crossing between the packages (repro_torch.utils.tree).

Params start in JAX and cross through numpy; the port flattens in
``jax.tree`` order, so its per-dtype-group flat vectors are the JAX server
plane's element for element.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import ARCHS
from repro.kernels.server_plane import _cat, _dtype_groups
from repro.models.api import build_model
from repro_torch.utils import tree


@pytest.fixture(scope="module")
def jparams():
    return build_model(ARCHS["paper-cnn"]).init(jax.random.PRNGKey(0))


def test_param_round_trip_bitwise(jparams):
    tp = tree.params_from_numpy(jparams)
    back = tree.params_to_numpy(tp)
    jl = jax.tree.leaves(jparams)
    bl = tree.leaves(back)
    assert len(jl) == len(bl) == 8
    for x, y in zip(jl, bl):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)
    assert sum(x.numel() for x in tree.leaves(tp)) == 54_784


def test_flat_order_equals_jax_tree_leaves(jparams):
    paths = ["/".join(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tp = tree.params_from_numpy(jparams)
    assert [p for p, _ in tree.flatten(tp)] == paths == [
        "body/conv1/w", "body/conv2/w", "fc1/b", "fc1/w", "fc2/b", "fc2/w",
        "fc3/b", "fc3/w"]
    for x, y in zip(jax.tree.leaves(jparams), tree.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    rebuilt = tree.unflatten(tp, tree.leaves(tp))
    assert [p for p, _ in tree.flatten(rebuilt)] == paths


def test_dtype_group_flat_vector_equals_jax_cat(jparams):
    mixed = dict(jparams, extra={"h": jnp.arange(6, dtype=jnp.float16)})
    jl = jax.tree.leaves(mixed)
    tl = tree.leaves(tree.params_from_numpy(mixed))
    jg, tg = _dtype_groups(jl), tree.dtype_groups(tl)
    assert list(jg.values()) == list(tg.values())
    for idxs in tg.values():
        jflat = _cat([jl[i].reshape(-1) for i in idxs])
        tflat = tree.cat([tl[i].reshape(-1) for i in idxs])
        np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
        # split_back inverts the concat, with and without a leading axis
        out = [None] * len(tl)
        tree.split_back(tflat, tl, idxs, out)
        for i in idxs:
            assert torch.equal(out[i], tl[i])
        stacked = [torch.stack([x, 2 * x]) for x in tl]
        sflat = tree.cat([stacked[i].reshape(2, -1) for i in idxs])
        tree.split_back(sflat, stacked, idxs, out)
        for i in idxs:
            assert torch.equal(out[i], stacked[i])
