"""Numpy counterparts of the Pillow and OpenCV calls the YOLO dataset and
its augmentations make, on ``(H, W, C)`` / ``(H, W)`` uint8 arrays (the JAX
package's ``data/yolo_dataset.py`` and ``data/augment.py`` call Pillow and
OpenCV; the port's machines may have neither).

Each function computes what the library computes, in the library's own
arithmetic, so the results are the library's bit for bit:

- :func:`resize`: Pillow's 8-bit ``Image.resize`` with ``LANCZOS`` or
  ``BILINEAR`` — coefficients in double, widened by the scale when
  downscaling, normalised and rounded to 22-bit fixed point; a horizontal
  pass into a uint8 image, then a vertical pass, each in Pillow's int32
  sums, rounded and clipped.
- :func:`pad`: ``Image.new`` + ``paste`` of a constant colour around.
- :func:`resized_crop`: resize, pad, then ``Image.crop`` at fractional
  bounds (each edge rounded by Python's ``round``, half to even; outside
  the canvas is black), with the resize computed inside the crop only.
- :func:`to_grey`: ``convert("L")``, (19595 R + 38470 G + 7471 B + 2^15) >> 16.
- :func:`blend`, :func:`brightness`, :func:`contrast`, :func:`color`: the
  ``ImageEnhance`` blends, ``in1 + α(in2 − in1)`` in single precision,
  truncated.
- :func:`rgb_to_hsv`, :func:`hsv_to_rgb`: ``convert("HSV")`` and back, in
  the mix of float and double that Pillow's C code evaluates.
- :func:`affine`: ``Image.transform(AFFINE, BILINEAR, fillcolor)``, the
  inverse map in double at pixel centres, a bilinear blend truncated.
- :func:`gaussian_blur`: OpenCV's bit-exact 8-bit ``GaussianBlur`` — the
  kernel in double rounded to 8 fraction bits by error diffusion, both
  passes in exact integers, one rounding; ``BORDER_REFLECT_101``.
- :func:`filter2d`: ``cv2.filter2D`` of a float32 image with a 3×3 float32
  kernel, ``BORDER_REFLECT_101`` (products summed in kernel order).
"""

from __future__ import annotations

import functools
import math

import numpy as np

LANCZOS = "lanczos"
BILINEAR = "bilinear"

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


_FILTERS = {LANCZOS: (_lanczos, 3.0), BILINEAR: (_bilinear, 1.0)}


@functools.lru_cache(maxsize=32)
def _coeffs(in_size: int, out_size: int, method: str):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a box
    of the whole input: ``(first (out,), k (out, ksize) int32)``, output o
    summing ``k[o, t] · in[first[o] + t]`` (zeros past its own taps).
    Cached and shared: read-only."""
    filt, support = _FILTERS[method]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0
                         else int(0.5 + w * (1 << _PRECISION_BITS)) for w in k]
    first.setflags(write=False)
    kk.setflags(write=False)
    return first, kk


def _pass(x: np.ndarray, axis: int, first: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One resampling pass along ``axis`` of the uint8 ``x``: Pillow's
    int32 sums from 2^21, >> 22, clipped to uint8 (``clip8``)."""
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = -1
    acc = None
    for t in range(kk.shape[1]):
        term = np.take(x, np.minimum(first + t, n - 1), axis=axis) * kk[:, t].reshape(shape)
        if acc is None:
            acc = term + (1 << (_PRECISION_BITS - 1))
        else:
            acc += term
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size, method: str = LANCZOS, window=None) -> np.ndarray:
    """``Image.resize(size=(width, height), method)`` of an 8-bit image
    (H, W[, C]): a horizontal pass into uint8, then a vertical one, each
    only where its size changes, as in Pillow. ``window`` (x0, y0, x1, y1),
    integers within the output, computes only that part of it (the same
    values: each output pixel depends on its own taps only)."""
    out_w, out_h = size
    h, w = img.shape[:2]
    x0, y0, x1, y1 = window if window is not None else (0, 0, out_w, out_h)
    if x1 <= x0 or y1 <= y0:
        return np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    if out_h != h:
        first, kk = _coeffs(h, out_h, method)
        first, kk = first[y0:y1], kk[y0:y1]
        ya = int(first.min())
        yb = int(min((first + kk.shape[1]).max(), h))  # the rows the taps read
    else:
        ya, yb = y0, y1
    out = img[ya:yb]
    if out_w != w:
        first_x, kk_x = _coeffs(w, out_w, method)
        out = _pass(out, 1, first_x[x0:x1], kk_x[x0:x1])
    else:
        out = out[:, x0:x1]
    if out_h != h:
        out = _pass(out, 0, first - ya, kk)
    return np.ascontiguousarray(out) if out is not img else img.copy()


def resized_crop(img: np.ndarray, size, vert: int, horiz: int, box,
                 method: str = LANCZOS, value: int = 127) -> np.ndarray:
    """``crop(pad(resize(img, size, method), vert, horiz, value), box)``,
    computing the resize only inside the box."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    out_w, out_h = size
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    # the canvas of the pad, then the resized image on it, each cut to the box
    cx0, cy0 = max(x0, 0), max(y0, 0)
    cx1, cy1 = min(x1, out_w + 2 * horiz), min(y1, out_h + 2 * vert)
    if cx1 > cx0 and cy1 > cy0:
        out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = value
    ix0, iy0 = max(x0, horiz), max(y0, vert)
    ix1, iy1 = min(x1, horiz + out_w), min(y1, vert + out_h)
    if ix1 > ix0 and iy1 > iy0:
        out[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = resize(
            img, size, method, (ix0 - horiz, iy0 - vert, ix1 - horiz, iy1 - vert))
    return out


def pad(img: np.ndarray, vert: int, horiz: int, value: int = 127) -> np.ndarray:
    """A (H + 2·vert, W + 2·horiz) canvas of ``value`` with ``img`` pasted
    at (horiz, vert)."""
    h, w = img.shape[:2]
    out = np.full((h + 2 * vert, w + 2 * horiz) + img.shape[2:], value, img.dtype)
    out[vert:vert + h, horiz:horiz + w] = img
    return out


def to_grey(img: np.ndarray) -> np.ndarray:
    """``convert("L")`` of an RGB image: (H, W) uint8."""
    v = img.astype(np.int32)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def blend(in1, in2, alpha: float) -> np.ndarray:
    """``Image.blend(in1, in2, alpha)``: in1 + α(in2 − in1) in single
    precision, clipped to [0, 255] and truncated. ``in1`` may be a scalar."""
    a = np.float32(alpha)
    in1 = np.asarray(in1, np.int32)
    diff = (np.asarray(in2, np.int32) - in1).astype(np.float32)
    v = in1.astype(np.float32) + a * diff
    return np.clip(v, 0, 255).astype(np.uint8)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``."""
    return blend(0, img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: the blend from the
    grey of the ``L`` image's mean, ``int(mean + 0.5)``."""
    grey = to_grey(img) if img.ndim == 3 else img
    mean = int(int(np.bincount(grey.ravel(), minlength=256) @ np.arange(256))
               / grey.size + 0.5)
    return blend(mean, img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``: the blend from the
    ``L`` image."""
    return blend(to_grey(img)[..., None], img, factor)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``convert("HSV")`` of an RGB image (Pillow's ``rgb2hsv``)."""
    v = img.astype(np.int32)
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(grey, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    # float h = bc - gc; or 2.0 + rc - bc and 4.0 + gc - rc in double
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc,
                          2.0 + rc.astype(np.float64) - bc.astype(np.float64),
                          4.0 + gc.astype(np.float64) - rc.astype(np.float64)))
    h = h.astype(np.float32).astype(np.float64)
    h = np.fmod(h / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int32), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int32), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], -1)
    return out.astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    return np.where(x < 0, -np.floor(-x + 0.5), np.floor(x + 0.5))


# per sextant 0-5 (and 6: no saturation), the indices into (v, q, p, t)
# of its r, g, b: Pillow's switch on i % 6
_HSV_PICK = np.array([[0, 3, 2], [1, 0, 2], [2, 0, 3], [2, 1, 0], [3, 2, 0], [0, 2, 1],
                      [0, 0, 0]], np.int64)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``Image.fromarray(hsv, "HSV").convert("RGB")`` (Pillow's
    ``hsv2rgb``)."""
    v8 = img.astype(np.int32)
    h, s, v = v8[..., 0], v8[..., 1], v8[..., 2]
    hf = h.astype(np.float32).astype(np.float64) * 6.0 / 255.0
    i = np.floor(hf).astype(np.int32)
    f = (hf - i.astype(np.float32)).astype(np.float32).astype(np.float64)
    fs = (s.astype(np.float32) / np.float64(255.0)).astype(np.float32).astype(np.float64)
    vf = v.astype(np.float64)
    p = np.clip(_round_half_away(vf * (1.0 - fs)), 0, 255).astype(np.int32)
    fsf = (fs.astype(np.float32) * f.astype(np.float32)).astype(np.float64)  # float · float
    q = np.clip(_round_half_away(vf * (1.0 - fsf)), 0, 255).astype(np.int32)
    t = np.clip(_round_half_away(vf * (1.0 - fs * (1.0 - f))), 0, 255).astype(np.int32)
    # the sextant's (r, g, b) of (v, q, p, t); s = 0 is grey (v, v, v)
    pick = _HSV_PICK[np.where(s == 0, 6, i % 6)]
    cand = np.stack([v, q, p, t], -1)
    return np.take_along_axis(cand, pick, -1).astype(np.uint8)


def affine(img: np.ndarray, coeffs, fill=(127, 127, 127)) -> np.ndarray:
    """``Image.transform(size, AFFINE, coeffs, BILINEAR, fillcolor=fill)``
    at the image's own size: output pixel (x, y) samples the input at
    (a·x' + b·y' + c, d·x' + e·y' + f) for its centre (x', y') = (x + ½,
    y + ½); a point outside [0, W) × [0, H) keeps ``fill``; inside, the
    bilinear blend of the pixel centres around it (edges clamped), in
    double, truncated."""
    a0, a1, a2, a3, a4, a5 = (float(c) for c in coeffs)
    grey = img.ndim == 2
    src = img[..., None] if grey else img
    h, w, c = src.shape
    xin = np.arange(w, dtype=np.float64) + 0.5
    yin = (np.arange(h, dtype=np.float64) + 0.5)[:, None]
    xx = a0 * xin + a1 * yin + a2
    yy = a3 * xin + a4 * yin + a5
    inside = (xx >= 0.0) & (xx < w) & (yy >= 0.0) & (yy < h)
    xx = np.where(inside, xx, 0.5) - 0.5
    yy = np.where(inside, yy, 0.5) - 0.5
    x = np.floor(xx)
    y = np.floor(yy)
    dx = (xx - x)[..., None]
    dy = (yy - y)[..., None]
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0, y1 = np.clip(y, 0, h - 1) * w, np.clip(y + 1, 0, h - 1) * w
    flat = src.reshape(h * w, c)

    def px(i):
        return flat[i].astype(np.float64)

    p00 = px(y0 + x0)
    top = p00 + (px(y0 + x1) - p00) * dx
    p10 = px(y1 + x0)
    bot = p10 + (px(y1 + x1) - p10) * dx
    top += (bot - top) * dy
    out = top.astype(np.uint8)
    out[~inside] = np.asarray(fill, np.uint8).reshape(-1)[:c]
    return out[..., 0] if grey else out


def _reflect101(img: np.ndarray, r: int) -> np.ndarray:
    widths = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, widths, mode="reflect")


@functools.lru_cache(maxsize=256)
def gaussian_kernel_q8(n: int, sigma: float) -> tuple:
    """OpenCV's 8-bit Gaussian kernel: ``getGaussianKernelBitExact`` (in
    double) rounded to 8 fraction bits by ``getGaussianKernelFixedPoint_ED``
    (error diffusion from the outside in; the centre takes what makes the
    sum 256)."""
    scale2x = -0.125 / (sigma * sigma)
    n2 = (n - 1) // 2
    values = []
    total = 0.0
    for x in range(1 - n, 1 - n + 2 * n2, 2):
        t = math.exp(float(x * x) * scale2x)
        values.append(t)
        total += t
    total = total * 2.0 + 1.0
    mul1 = 1.0 / total
    err = 0.0
    out = [0] * n
    for i in range(n2):
        adj = values[i] * mul1 * 256.0 + err
        v = round(adj)  # cvRound: nearest, half to even
        err = adj - v
        out[i] = out[n - 1 - i] = v
    out[n2] = 256 - 2 * sum(out[:n2])
    return tuple(out)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)`` of an 8-bit image:
    kernel size ``round(σ·6 + 1) | 1``, :func:`gaussian_kernel_q8` in both
    directions, exact integer sums, (Σ + 2^15) >> 16, reflect-101 borders.
    The sums run in float32 (all are integers below 2^24, so exact), the
    symmetric taps paired."""
    n = int(np.rint(sigma * 3 * 2 + 1)) | 1
    if n == 1:
        return img.copy()
    k = gaussian_kernel_q8(n, float(sigma))
    r = n // 2
    h, w = img.shape[:2]
    src = _reflect101(img, r).astype(np.float32)

    def taps(x, axis, size):
        def at(j):
            return x[:, j:j + size] if axis == 1 else x[j:j + size]

        acc = at(r) * np.float32(k[r])
        for j in range(r):
            acc += (at(j) + at(n - 1 - j)) * np.float32(k[j])
        return acc

    acc = taps(taps(src, 1, w), 0, h)  # 8, then 16 fraction bits
    acc += 1 << 15
    acc *= 2.0 ** -16  # exact: a power of two
    return np.floor(acc).astype(np.uint8)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of a float32 image with a 3×3
    float32 kernel (correlation, anchor at the centre), reflect-101
    borders; the products summed in kernel order."""
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    h, w = img.shape[:2]
    widths = [(ry, ry), (rx, rx)] + [(0, 0)] * (img.ndim - 2)
    src = np.pad(np.asarray(img, np.float32), widths, mode="reflect")
    acc = np.zeros(img.shape, np.float32)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                acc = acc + kernel[i, j] * src[i:i + h, j:j + w]
    return acc
