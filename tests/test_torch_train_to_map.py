"""The port's ``tools/train_to_map.py`` and the learning-rate schedules it
runs (``train/optim.py``) against the repository's JAX tool on the CPU.

Tolerances: none. The schedules equal ``optax.join_schedules`` of the JAX
tool's two recipes at every step from 0 to ``steps``, bit for bit in f32
(optax evaluated op by op, on an int32 count as Adam's state holds it).
The tool prints, for each family, one JSON line with exactly the JAX
tool's keys (read from its source) and finite values.
"""

import ast
import contextlib
import importlib.util
import io
import json
import math
import os

import numpy as np
import pytest

from mit_driverless_cv_traininginfra_tpu_torch.train import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "mit_driverless_cv_traininginfra_tpu_torch", "tools",
                    "train_to_map.py")
JAX_TOOL = os.path.join(ROOT, "tools", "train_to_map.py")


def _tool():
    spec = importlib.util.spec_from_file_location("port_tools_train_to_map", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _optax_recipe(family, steps, lr=5e-4, hold_frac=0.67):
    """The JAX tool's schedules (tools/train_to_map.py)."""
    import optax

    if family == "yolo":
        hold = int(steps * hold_frac)
        warm = min(200, hold // 2)
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warm), optax.constant_schedule(lr),
             optax.cosine_decay_schedule(lr, steps - hold)], [warm, hold])
    return optax.join_schedules(
        [optax.constant_schedule(3e-3), optax.cosine_decay_schedule(3e-3, steps // 3)],
        [2 * steps // 3])


@pytest.mark.parametrize("family,steps", [("yolo", 3000), ("yolo", 300), ("yolo", 2),
                                          ("yolo", 401), ("rektnet", 1500),
                                          ("rektnet", 300), ("rektnet", 3)])
def test_schedules_bit_equal_to_optax(family, steps):
    import jax.numpy as jnp

    tool = _tool()
    ref = _optax_recipe(family, steps)
    port = (tool.yolo_schedule(steps, 5e-4, 0.67) if family == "yolo"
            else tool.rektnet_schedule(steps))
    want = np.asarray([ref(jnp.asarray(c, jnp.int32)) for c in range(steps + 1)], np.float32)
    got = np.asarray([port(c) for c in range(steps + 1)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert all(type(port(c)) is float for c in (0, steps))


def test_single_schedules_bit_equal_to_optax():
    import jax.numpy as jnp
    import optax

    pairs = [(optim.linear_schedule(1e-3, 2e-5, 37), optax.linear_schedule(1e-3, 2e-5, 37)),
             (optim.linear_schedule(0.1, 0.2, 0), optax.linear_schedule(0.1, 0.2, 0)),
             (optim.cosine_decay_schedule(0.3, 77), optax.cosine_decay_schedule(0.3, 77))]
    for port, ref in pairs:
        for c in range(0, 130):
            assert np.float32(port(c)) == np.float32(ref(jnp.asarray(c, jnp.int32))), c
    with pytest.raises(ValueError):  # as optax refuses it (RektNet at --steps 2)
        optim.cosine_decay_schedule(3e-3, 0)


def _jax_tool_keys():
    """The keys of each ``json.dumps({...})`` in the JAX tool, by metric."""
    keys = {}
    for node in ast.walk(ast.parse(open(JAX_TOOL).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            names = [k.value for k in d.keys]
            keys[d.values[names.index("metric")].value] = names
    return keys


@pytest.mark.parametrize("argv", [
    ["--steps", "2", "--size", "64", "--pool", "4", "--batch", "2", "--eval-n", "4"],
    # --steps 2 leaves the cosine 0 steps, which optax refuses: 3 is the least
    ["--family", "rektnet", "--steps", "3", "--batch", "4"],
])
def test_tool_prints_the_jax_tools_line(argv):
    keys = _jax_tool_keys()
    assert set(keys) == {"flagship_train_to_map_416", "rektnet_train_to_l2_80"}
    tool = _tool()
    assert (tool.RK_POOL, tool.RK_EVAL, tool.RK_CALIB) == (2048, 256, 64)  # the JAX tool's
    tool.RK_POOL, tool.RK_EVAL, tool.RK_CALIB = 16, 8, 8  # a CPU's share
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        assert tool.main(argv + ["--device", "cpu"]) == 0
    (line,) = out.getvalue().strip().splitlines()
    got = json.loads(line)
    assert list(got) == keys[got["metric"]]
    assert got["steps"] == int(argv[argv.index("--steps") + 1])
    assert all(math.isfinite(v) for k, v in got.items() if k != "metric")
    for k in ("map_f32_conf08", "recall_f32", "precision_f32", "map_int8_conf08"):
        assert 0 <= got.get(k, 0) <= 1
