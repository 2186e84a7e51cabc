"""Remote-URI ingestion seam (the port's copy of the JAX package's
``data/uri.py``).

A cfg names its dataset and weights by URI, which may be a ``gs://`` blob
(``model_cfg/yolo_baseline.cfg`` ``train_uri``/``weights_uri``). With no
network, remote URIs resolve through a local mirror directory:

    gs://bucket/path/file.csv  →  <mirror>/bucket/path/file.csv
    https://host/path/file     →  <mirror>/host/path/file

The mirror root comes from the ``MDCV_DATA_MIRROR`` environment variable
(or an explicit argument). Local paths pass through untouched.
"""

from __future__ import annotations

import os
from typing import Optional

_SCHEMES = ("gs://", "https://", "http://", "s3://")

MIRROR_ENV = "MDCV_DATA_MIRROR"


def is_remote(uri: str) -> bool:
    return any(uri.startswith(s) for s in _SCHEMES)


def resolve_uri(uri: Optional[str], mirror: Optional[str] = None,
                must_exist: bool = True) -> Optional[str]:
    """Map a possibly-remote URI to a local path (see the module docstring)."""
    if not uri or not is_remote(uri):
        return uri
    mirror = mirror or os.environ.get(MIRROR_ENV)
    if not mirror:
        raise FileNotFoundError(
            f"remote URI {uri!r} needs a local mirror: set ${MIRROR_ENV} "
            "to a directory mirroring the bucket layout (no egress here)")
    rel = uri.split("://", 1)[1]
    local = os.path.join(mirror, rel)
    if must_exist and not os.path.exists(local):
        raise FileNotFoundError(
            f"remote URI {uri!r} not found in mirror: expected {local}")
    return local
