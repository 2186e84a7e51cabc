"""Image decode for the host input path (the port's copy of the JAX
package's ``data/decode.py`` routing, returning numpy arrays).

Decodes go through the repository's native core (``native/``: libjpeg and
libpng behind a C interface) when its library builds, else through PIL or
OpenCV when one of them is installed, else raise. ``.npy`` frames need
none of them: a machine without PIL and OpenCV (the card's) reads those.
:func:`imread_bgr` is the RektNet loaders' ``cv2.imread``: BGR, or None
for a file that cannot be read.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def native_core():
    """The repository's ``native`` module when its library loads, else
    None (checked once)."""
    try:
        import native
    except ImportError:
        return None
    return native if native.available() else None


def read_rgb(path: str) -> np.ndarray:
    """A JPEG/PNG file (native core, PIL or OpenCV) or a ``.npy`` array →
    (H, W, 3) RGB uint8."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    nat = native_core()
    if nat is not None:
        with open(path, "rb") as f:
            data = f.read()
        try:
            return nat.decode_image(data)
        except ValueError:  # neither JPEG nor PNG: the libraries may read it
            pass
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"cannot decode {path}: the native core did not "
                           "build and neither PIL nor OpenCV is installed "
                           "(.npy frames need none of them)") from None
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot decode {path}")
    return np.ascontiguousarray(img[..., ::-1])


def imread_bgr(path: str):
    """``cv2.imread``'s result for the RektNet loaders: (H, W, 3) uint8 BGR
    (``.npy`` arrays hold RGB, as for :func:`read_rgb`), or None where the
    file is missing or does not decode."""
    try:
        rgb = read_rgb(path)
    except (OSError, ValueError):  # missing, truncated or not an image
        return None
    return np.ascontiguousarray(rgb[..., ::-1])
