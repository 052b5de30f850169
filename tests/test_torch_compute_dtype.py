"""The convnets' ``compute_dtype`` against the JAX package's: bfloat16
compute over float32 params, the same weights and NHWC batch, forward
log-probs in eval and in train mode (batch statistics), on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import random  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.models import mnist_cnn as jax_mnist  # noqa: E402
from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax  # noqa: E402

# bfloat16 keeps 8 bits of mantissa: the two frameworks round the
# convolutions' and batchnorms' outputs to bfloat16 after summing in
# different orders, and the logits themselves are bfloat16, whose ulp is
# 2^-6 = 0.0156 for magnitudes in [2, 4) — one logit's ulp moves its
# log-prob by as much.  So rtol = atol = 2e-2, the reference's own
# bfloat16 flash tolerance that the port's bfloat16 tests use
# (tests/test_torch_flash_backward.py).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

_MODELS = {
    "cifar_convnet": (lambda cd: jax_cifar(compute_dtype=cd, dropout_rate=0.0),
                      lambda cd: cifar_convnet(compute_dtype=cd,
                                               dropout_rate=0.0), 3),
    "mnist_cnn": (lambda cd: jax_mnist(compute_dtype=cd),
                  lambda cd: mnist_cnn(compute_dtype=cd), 1),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_bfloat16_forward_matches_jax(name, train):
    jmake, tmake, ch = _MODELS[name]
    jm, tm = jmake(jnp.bfloat16), tmake(torch.bfloat16)
    params, state = jm.init(random.PRNGKey(3))
    x = np.random.RandomState(3).randn(8, 32, 32, ch).astype(np.float32)
    want, _ = jax.jit(jm.apply, static_argnames=("train",))(
        params, state, jnp.asarray(x), train=train)
    tp, ts = from_jax(jax.device_get(params), jax.device_get(state))
    got, new_state = tm.apply(tp, ts, torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)
    # the params and the running statistics stay float32
    assert all(v.dtype == torch.float32 for d in new_state.values()
               for v in d.values())
    # bfloat16 compute moved the result: the comparison is not float32's
    f32, _ = tmake(None).apply(tp, ts, torch.from_numpy(x), train=train)
    assert not torch.equal(f32, got)
