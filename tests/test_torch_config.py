"""The port's own copies of the JAX package's jax-free modules — the cfg
parser and generator (``config/``), the capacity policy
(``infer/capacity.py``) and the synthetic data (``data/synthetic.py``) —
give what the originals give."""

import numpy as np
import pytest

from _torch_port import TINY_CFG, spec_key, tiny_port_spec, tiny_spec
from mit_driverless_cv_traininginfra_tpu.config.cfg_factory import (
    yolov3_cfg as jyolov3_cfg,
)
from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.data import synthetic as jsynthetic
from mit_driverless_cv_traininginfra_tpu.infer.capacity import (
    AdaptiveCapacity as JAdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.config import darknet_cfg
from mit_driverless_cv_traininginfra_tpu_torch.config.cfg_factory import yolov3_cfg
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import AdaptiveCapacity


@pytest.mark.parametrize("size", [416, 608])
def test_flagship_spec_equals_jax(size):
    assert yolov3_cfg(size, size) == jyolov3_cfg(size, size)
    spec = flagship_spec(size)
    assert spec_key(spec) == spec_key(jflagship_spec(size))
    assert spec.out_channels == jflagship_spec(size).out_channels
    assert isinstance(spec.blocks[0], darknet_cfg.ConvBlock)


def test_tiny_cfg_parses_as_jax_and_from_text():
    assert spec_key(tiny_port_spec()) == spec_key(tiny_spec())
    with open(TINY_CFG) as f:
        text = f.read()
    assert darknet_cfg.spec_from_text(text, vanilla_anchor=True) == tiny_port_spec()
    with pytest.raises(ValueError, match="first block"):
        darknet_cfg.spec_from_text("[convolutional]\nfilters=1\n")


def test_synthetic_batches_equal_jax():
    a, ta = synthetic.yolo_batch(np.random.default_rng(3), 2, 96)
    b, tb = jsynthetic.yolo_batch(np.random.default_rng(3), 2, 96)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)
    c, pc = synthetic.rektnet_batch(np.random.default_rng(4), 3)
    d, pd = jsynthetic.rektnet_batch(np.random.default_rng(4), 3)
    np.testing.assert_array_equal(c, d)
    np.testing.assert_array_equal(pc, pd)


def test_adaptive_capacity_decides_as_jax():
    rng = np.random.default_rng(5)
    ours = AdaptiveCapacity(floor=16, quantum=16, shrink_patience=4)
    theirs = JAdaptiveCapacity(floor=16, quantum=16, shrink_patience=4)
    for load in rng.integers(0, 200, 120):
        for policy in (ours, theirs):
            policy.observe(int(load), capacity=96)
        assert ours.capacity(8, 16) == theirs.capacity(8, 16)
    assert (ours.grows, ours.shrinks, ours.overflows) == (
        theirs.grows, theirs.shrinks, theirs.overflows)
