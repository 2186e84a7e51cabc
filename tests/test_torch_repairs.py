"""Pins of two repairs of the port, against the JAX package on the CPU
(the card's side is in ``test_torch_cuda_serving.py``):

- the uint8 feed's normalise is ``x · fl(1/255)``, bit-equal to the JAX
  package's jitted ``u8.astype(f32) / 255.0`` (XLA folds the constant
  divisor into a reciprocal multiply) for all 256 values;
- the int8 weight scales ``max|w| / 127`` are the IEEE quotient, as the
  JAX package's eager division is, so every quantized leaf is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    normalize_u8,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_uint8_normalise_bit_equal_to_jitted_jax():
    u8 = np.arange(256, dtype=np.uint8)
    ref = jax.jit(lambda x: x.astype(jnp.float32) / 255.0)(jnp.asarray(u8))
    got = normalize_u8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _bits(ref))
    # the IEEE quotient, which the port used to take, is 1 ulp off for
    # some of them: the pin can see the difference
    quot = (torch.from_numpy(u8).float() / 255.0).numpy()
    assert (quot.view(np.int32) != _bits(ref)).sum() > 0


@pytest.mark.parametrize("shape,amax", [((1024, 512, 3, 3), 3.7),
                                        ((64, 3, 7, 7), 1.0),
                                        ((32, 64, 1, 1), 1e-13)])
def test_quantize_conv_leaves_bit_equal_to_jax(shape, amax):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, (shape[0], 1, 1, 1))
         ).astype(np.float32)
    w[0] = 0.0                           # an all-zero channel: the 1e-12 floor
    b = rng.standard_normal(shape[0]).astype(np.float32)
    got = quantize._quantize_conv(torch.from_numpy(w), torch.from_numpy(b),
                                  amax)
    ref = jquantize._quantize_conv(w.transpose(2, 3, 1, 0), b, amax)  # HWIO
    np.testing.assert_array_equal(got["wq"].numpy(),
                                  np.asarray(ref["wq"]).transpose(3, 2, 0, 1))
    for k in ("scale", "b", "sx_inv"):
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      _bits(ref[k]), err_msg=k)
