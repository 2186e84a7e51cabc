"""The port's leaky ReLU rounds as the JAX package's ``_leaky``.

JAX's ``jnp.where(x >= 0, x, x * slope)`` on a bf16 tensor with a Python
float multiplies by the slope rounded to bf16 (0.10009765625) and rounds
the product once. ``F.leaky_relu(x, 0.1)`` multiplies by the f32 0.1 and
lands one bf16 ulp away on about a tenth of the negative values; the int8
path requantizes every leaky output, so such an ulp becomes an int8 flip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mit_driverless_cv_traininginfra_tpu.models.darknet import _leaky as jleaky
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import _leaky


def _inputs():
    return np.random.default_rng(0).normal(0, 3, 200_000).astype(np.float32)


def test_bf16_leaky_bit_equal_to_jax_and_leaky_relu_is_not():
    x = _inputs()
    ref = np.asarray(jleaky(jnp.asarray(x, jnp.bfloat16), 0.1).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _leaky(xt, 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)  # bit for bit
    # the fault this guards: leaky_relu with the f32 slope differs
    old = F.leaky_relu(xt, 0.1).float().numpy()
    assert int((old != ref).sum()) > 1000


@pytest.mark.parametrize("slope", [0.1, 0.2])
def test_f32_leaky_bit_equal_to_jax(slope):
    x = _inputs()
    ref = np.asarray(jleaky(jnp.asarray(x), slope))
    np.testing.assert_array_equal(_leaky(torch.from_numpy(x), slope).numpy(), ref)
