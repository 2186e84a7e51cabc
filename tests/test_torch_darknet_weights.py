"""The port's Darknet ``.weights`` reader and writer against the JAX
package's (``models/darknet.py``): a file the JAX package writes from
seeded parameters loads in the port to the same leaves bit for bit, and
the port writes the same bytes back, the head slicing of
``start_weights_dim`` included."""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_port import TINY_CFG
from mit_driverless_cv_traininginfra_tpu.config import (
    load_network_spec as jax_load_spec,
)
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    load_network_spec,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet


def _specs(path):
    return (jax_load_spec(path, vanilla_anchor=True),
            load_network_spec(path, vanilla_anchor=True))


def _port_trees(jparams, jstate):
    """The JAX trees as the port's OIHW tensors."""
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)  # writable copies
    return convert.from_jax(to_np(jparams)), convert.from_jax(to_np(jstate))


def _assert_same_leaves(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_leaves(a[k], b[k])
        else:
            assert a[k].shape == b[k].shape, k
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


def _blank(jparams, jstate):
    """Port trees of the right shapes holding other values."""
    p, s = _port_trees(jparams, jstate)
    return (jax.tree_util.tree_map(lambda t: torch.full_like(t, 7.0), p),
            jax.tree_util.tree_map(lambda t: torch.full_like(t, 7.0), s))


@pytest.mark.parametrize("seed", [0, 3])
def test_weights_written_by_jax_load_and_write_back(tmp_path, seed):
    jspec, spec = _specs(TINY_CFG)
    jp, js = jdarknet.init_params(jspec, jax.random.PRNGKey(seed))
    path = str(tmp_path / "jax.weights")
    header = np.arange(5, dtype=np.int32)
    jdarknet.save_darknet_weights(jspec, jp, js, path, header=header)

    params, state, got_header = darknet.load_darknet_weights(
        spec, *_blank(jp, js), path)
    np.testing.assert_array_equal(got_header, header)
    want_p, want_s = _port_trees(jp, js)
    _assert_same_leaves(params, want_p)
    _assert_same_leaves(state, want_s)

    out = str(tmp_path / "port.weights")
    darknet.save_darknet_weights(spec, params, state, out, header=header)
    with open(path, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_start_weights_dim_slices_a_wider_head(tmp_path):
    """A file written with 2-class heads (21 filters) loads into the
    1-class cfg (18) with ``start_weights_dim`` 21,21: the first 18 of each
    head's filters, as the JAX package reads them; both packages then
    write the same bytes."""
    with open(TINY_CFG) as f:
        text = f.read()
    wide = str(tmp_path / "wide.cfg")
    with open(wide, "w") as f:
        f.write(text.replace("classes=1", "classes=2"))
    jwide, _ = _specs(wide)
    jp, js = jdarknet.init_params(jwide, jax.random.PRNGKey(5))
    path = str(tmp_path / "wide.weights")
    jdarknet.save_darknet_weights(jwide, jp, js, path)

    jspec, spec = _specs(TINY_CFG)
    j0, s0 = jdarknet.init_params(jspec, jax.random.PRNGKey(0))
    jp1, js1, _ = jdarknet.load_darknet_weights(jspec, j0, s0, path,
                                                start_weights_dim=(21, 21))
    params, state, _ = darknet.load_darknet_weights(
        spec, *_blank(j0, s0), path, start_weights_dim=(21, 21))
    want_p, want_s = _port_trees(jp1, js1)
    _assert_same_leaves(params, want_p)
    _assert_same_leaves(state, want_s)

    a, b = str(tmp_path / "a.weights"), str(tmp_path / "b.weights")
    jdarknet.save_darknet_weights(jspec, jp1, js1, a)
    darknet.save_darknet_weights(spec, params, state, b)
    assert os.path.getsize(a) == os.path.getsize(b)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_a_short_file_raises(tmp_path):
    jspec, spec = _specs(TINY_CFG)
    jp, js = jdarknet.init_params(jspec, jax.random.PRNGKey(0))
    path = str(tmp_path / "short.weights")
    jdarknet.save_darknet_weights(jspec, jp, js, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="ends after"):
        darknet.load_darknet_weights(spec, *_blank(jp, js), path)
