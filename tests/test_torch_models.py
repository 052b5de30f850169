"""The port's convnets against the JAX package's, on the same weights and
the same NHWC batch: forward log-probs, parameter gradients, batchnorm
running statistics and parameter counts (float32, the working dtype)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import random  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.models import mnist_cnn as jax_mnist  # noqa: E402
from distlearn_tpu.models.core import loss_fn as jax_loss_fn  # noqa: E402
from distlearn_tpu.models.core import param_count as jax_param_count  # noqa: E402
from distlearn_tpu_torch.models import (cifar_convnet, loss_fn, mnist_cnn,  # noqa: E402
                                        param_count)
from distlearn_tpu_torch.models.convert import from_jax, to_jax  # noqa: E402

# float32 on both sides.  XLA and PyTorch run the convolutions with
# different algorithms (different summation orders), and batchnorm's
# E[x^2] - E[x]^2 amplifies those last-bit differences; the log-probs of
# order 1 agree to 4e-6 (measured), so 1e-5 absolute.
LOGP_ATOL = 1e-5
# Gradients are held relative to each leaf's largest entry: the same
# summation differences, carried back through four batchnorms, land at
# ~6e-6 of the leaf's scale (measured), so 1e-4.  The conv biases that
# feed a batchnorm have an exact gradient of zero, and both sides hold
# rounding noise of ~1e-7 there, hence the 1e-6 floor.
GRAD_RTOL_OF_MAX = 1e-4
GRAD_ATOL = 1e-6

_MODELS = {
    "cifar_convnet": (lambda: jax_cifar(dropout_rate=0.0),
                      lambda: cifar_convnet(dropout_rate=0.0), 3),
    "mnist_cnn": (jax_mnist, mnist_cnn, 1),
}


def _setup(name, batch=4, seed=0):
    jmake, tmake, ch = _MODELS[name]
    jm, tm = jmake(), tmake()
    params, state = jm.init(random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 32, 32, ch).astype(np.float32)
    y = (np.arange(batch) % 10).astype(np.int32)
    tp, ts = from_jax(jax.device_get(params), jax.device_get(state))
    return jm, tm, params, state, tp, ts, x, y


def _jit_apply(jm):
    return jax.jit(jm.apply, static_argnames=("train",))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("name", sorted(_MODELS))
@pytest.mark.parametrize("train", [True, False])
def test_forward_log_probs_match_jax(name, train):
    jm, tm, params, state, tp, ts, x, _ = _setup(name)
    jlp, _ = _jit_apply(jm)(params, state, jnp.asarray(x), train=train)
    tlp, _ = tm.apply(tp, ts, torch.from_numpy(x), train=train)
    assert tlp.shape == (4, 10) and tlp.dtype == torch.float32
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=LOGP_ATOL)


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_param_gradients_match_jax(name):
    jm, tm, params, state, tp, ts, x, y = _setup(name)

    def _jloss(p):
        return jax_loss_fn(jm, p, state, jnp.asarray(x), jnp.asarray(y),
                           train=True)[0]

    jgrads = jax.jit(jax.grad(_jloss))(params)
    tp = {k: {n: v.requires_grad_() for n, v in d.items()}
          for k, d in tp.items()}
    loss, _ = loss_fn(tm, tp, ts, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    tgrads = {k: {n: v.grad for n, v in d.items()} for k, d in tp.items()}
    expect, _ = from_jax(jax.device_get(jgrads), {})
    for k in expect:
        for n in expect[k]:
            e, g = expect[k][n].numpy(), tgrads[k][n].numpy()
            assert g.shape == e.shape, (k, n)
            np.testing.assert_allclose(
                g, e, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(e).max() + GRAD_ATOL,
                err_msg=f"{k}.{n}")


def test_batchnorm_running_stats_match_jax():
    jm, tm, params, state, tp, ts, x, _ = _setup("cifar_convnet", batch=8)
    _, jstate = _jit_apply(jm)(params, state, jnp.asarray(x), train=True)
    _, tstate = tm.apply(tp, ts, torch.from_numpy(x), train=True)
    for layer in jstate:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                tstate[layer][stat].numpy(), np.asarray(jstate[layer][stat]),
                rtol=1e-5, atol=1e-6, err_msg=f"{layer}.{stat}")
            # the running statistics never carry an autograd graph
            assert not tstate[layer][stat].requires_grad


@pytest.mark.parametrize("name,count", [("cifar_convnet", 4_328_970),
                                        ("mnist_cnn", 10_842)])
def test_param_count_matches_jax(name, count):
    jm, tm, params, _, tp, _, _, _ = _setup(name)
    own, _ = tm.init(0, device="cpu")
    assert param_count(tp) == param_count(own) == jax_param_count(params) \
        == count


def test_from_jax_moves_layouts():
    _, _, params, _, tp, _, _, _ = _setup("cifar_convnet")
    assert tuple(params["conv1"]["w"].shape) == (5, 5, 3, 64)        # HWIO
    assert tuple(tp["conv1"]["w"].shape) == (64, 3, 5, 5)            # OIHW
    assert tuple(params["linear"]["w"].shape) == (2048, 10)          # [in, out]
    assert tuple(tp["linear"]["w"].shape) == (10, 2048)              # [out, in]
    np.testing.assert_array_equal(
        tp["conv2"]["w"].numpy()[7, 3, 1, 4],
        np.asarray(params["conv2"]["w"])[1, 4, 3, 7])
    assert len(_leaves(params)) == sum(len(d) for d in tp.values())


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_to_jax_inverts_from_jax(name):
    """JAX -> port -> JAX gives the JAX pytree back bit for bit (params and
    batchnorm state), and port -> JAX -> port the port's."""
    jm, tm, params, state, tp, ts, _, _ = _setup(name)
    for jtree, ttree in ((params, tp), (state, ts)):
        back = to_jax(ttree)
        jleaves = jax.tree_util.tree_leaves(jax.device_get(jtree))
        bleaves = jax.tree_util.tree_leaves(back)
        assert len(bleaves) == len(jleaves)
        for b, j in zip(bleaves, jleaves):
            assert b.shape == j.shape and b.dtype == j.dtype
            np.testing.assert_array_equal(b, j)
        again, _ = from_jax(back, {})
        for a, t in zip(jax.tree_util.tree_leaves(again),
                        jax.tree_util.tree_leaves(ttree)):
            assert torch.equal(a, t)
