"""numpy-only modules of the JAX package, shared by loading their files.

``infer/capacity.py`` and ``data/synthetic.py`` use numpy alone, but their
packages' ``__init__`` files import JAX (``infer/__init__.py`` imports the
serving module, ``data/__init__.py`` the device pool). Loading the file by
path runs the module without its package ``__init__``, so the port shares
the code instead of copying it and still never imports ``jax``.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

_JAX_PKG = (Path(__file__).resolve().parent.parent
            / "mit_driverless_cv_traininginfra_tpu")


@functools.cache
def _load(relpath: str):
    name = "_mdcv_shared_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / relpath)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_JAX_PKG / relpath}")
    had_jax = "jax" in sys.modules
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    if not had_jax and "jax" in sys.modules:
        raise ImportError(f"{relpath} imported jax; the port may only share "
                          "numpy-only modules")
    return module


def capacity():
    """``infer/capacity.py`` (``AdaptiveCapacity``)."""
    return _load("infer/capacity.py")


def synthetic():
    """``data/synthetic.py`` (``yolo_batch``, ``cone_scene``, ...)."""
    return _load("data/synthetic.py")
