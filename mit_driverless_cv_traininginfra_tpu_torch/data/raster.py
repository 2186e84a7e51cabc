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

And the OpenCV calls of the RektNet dataset and the visualisations (the
JAX package's ``ops/heatmap.py`` and ``utils/vis.py``):

- :func:`resize_linear`: ``cv2.resize`` with its default ``INTER_LINEAR``
  of a uint8 (H, W[, C]) image (11-bit fixed-point weights, the vertical
  sum of two ``(b·(S >> 4)) >> 16`` terms, ``(v + 2) >> 2``; the rows
  above and below the input blend a clamped row with itself) or of a
  float64 (H, W) map (double weights, each pass the fused
  ``fma(S1 − S0, f, S0)`` that OpenCV's build runs).
- :func:`gaussian_blur_5x5_f64`: ``cv2.GaussianBlur(m, (5, 5), 0)`` of a
  float64 map: OpenCV's σ = 0 table [1, 4, 6, 4, 1] / 16, the row pass
  fused multiply-adds over groups of four columns and plain ones for the
  rest, the column pass symmetric and plain; reflect-101 borders.
- :func:`copy_make_border_constant`: ``cv2.copyMakeBorder(...,
  BORDER_CONSTANT, value)``.

:func:`fma` is a correctly rounded fused multiply-add in numpy, which the
two float64 functions need to match OpenCV's fused arithmetic.
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


# ---------------------------------------------------------------------------
# OpenCV's linear resize, 5×5 blur and constant border
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitter for doubles


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _fma_exact(a, b, c):
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    # v rounded to odd: an inexact v with an even last bit steps towards err
    even = (np.ascontiguousarray(v).view(np.int64) & 1) == 0
    v = np.where(even & (err != 0), np.nextafter(v, np.copysign(np.inf, err)), v)
    return th + v


def fma(a, b, c) -> np.ndarray:
    """``a·b + c`` rounded once, in float64 (operands far from overflow and
    underflow): the product exact as a sum of two doubles (Dekker), ``c``
    added exactly (two-sum), the low parts rounded to odd and the whole
    rounded to nearest (Boldo and Melquiond's emulated FMA). Where ``a`` or
    ``b`` is 0 the product is exact and the plain ``a·b + c`` is taken, so
    sparse maps (the one-hot heatmaps) pay for their nonzeros only."""
    a, b, c = np.broadcast_arrays(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                  np.asarray(c, np.float64))
    out = a * b + c
    nz = (a != 0) & (b != 0)
    if nz.any():
        out[nz] = _fma_exact(a[nz], b[nz], c[nz])
    return out


@functools.lru_cache(maxsize=256)
def _linear_taps(in_size: int, out_size: int, clamp: bool, f32: bool):
    """OpenCV's linear taps along one axis: the first source index and the
    second tap's weight ``f`` from ``fma(d + ½, in/out, −½)`` (rounded to
    float32 before the floor for uint8 images, ``f32``). ``clamp``
    (columns) pins a tap outside the input to weight 0 and marks the right
    edge's plain copies (``hi``); rows keep their weights and clamp only
    the row index. Returns ``(s0, s1, f, hi)``, read-only."""
    f = fma(np.arange(out_size) + 0.5, in_size / out_size, -0.5)
    if f32:
        f = f.astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    hi = np.zeros(out_size, bool)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0.0, 0
        hi = s >= in_size - 1
        f[hi], s[hi] = 0.0, in_size - 1
    out = (np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1), f, hi)
    for a in out:
        a.setflags(write=False)
    return out


def _q11(w: np.ndarray) -> np.ndarray:
    """float32 weights → OpenCV's 11-bit fixed point (``saturate_cast<short>
    (w·2048)``: rounded half to even)."""
    return np.rint(w * np.float32(2048)).astype(np.int64)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size=(width, height))`` with ``INTER_LINEAR`` of a
    uint8 (H, W[, C]) image or a float64 (H, W) map (or a stack of them,
    (..., H, W)), bit for bit.

    uint8: float32 weights in 11-bit fixed point; exact integer horizontal
    sums (the right edge copies its pixel ×2048); vertically
    ``((b0·(S0 >> 4)) >> 16) + ((b1·(S1 >> 4)) >> 16)``, then
    ``(v + 2) >> 2``. An exact halving of both sides is OpenCV's area
    average ``(a + b + c + d + 2) >> 2``. float64: double weights, each pass
    ``fma(S1 − S0, f, S0)``. An unchanged size is a copy."""
    out_w, out_h = size
    f64 = img.dtype == np.float64
    h, w = img.shape[-2:] if f64 else img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    f32 = img.dtype == np.uint8
    x0, x1, fx, xhi = _linear_taps(w, out_w, True, f32)
    y0, y1, fy, _ = _linear_taps(h, out_h, False, f32)
    if f64:
        rows = fma(img[..., x1] - img[..., x0], fx, img[..., x0])
        rows[..., xhi] = img[..., x0[xhi]]
        return fma(rows[..., y1, :] - rows[..., y0, :], fy[:, None], rows[..., y0, :])
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear: uint8 or float64 input, not {img.dtype}")
    if out_w * 2 == w and out_h * 2 == h:
        x = img.astype(np.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    a0, a1 = _q11(np.float32(1) - fx), _q11(fx)
    b0, b1 = _q11(np.float32(1) - fy), _q11(fy)
    src = img.astype(np.int64)
    col = (1, -1) + (1,) * (img.ndim - 2)
    rows = src[:, x0] * a0.reshape(col) + src[:, x1] * a1.reshape(col)
    rows[:, xhi] = src[:, x0[xhi]] * 2048
    row = (-1,) + (1,) * (img.ndim - 1)
    v = (((b0.reshape(row) * (rows[y0] >> 4)) >> 16)
         + ((b1.reshape(row) * (rows[y1] >> 4)) >> 16))
    return ((v + 2) >> 2).astype(np.uint8)


_BLUR5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # OpenCV's σ = 0 table for 5 taps


def gaussian_blur_5x5_f64(m: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(m, (5, 5), 0)`` of a float64 (H, W) map (H, W ≥ 3)
    or a stack of them (..., H, W), reflect-101 borders. The row pass adds
    the five taps in order, fused over the first ``4·⌊W/4⌋`` columns
    (OpenCV's vector loop) and plain over the rest; the column pass is
    ``k2·c + k1·(up1 + down1) + k0·(up2 + down2)``, plain."""
    m = np.asarray(m, np.float64)
    h, w = m.shape[-2:]
    p = np.pad(m, [(0, 0)] * (m.ndim - 2) + [(2, 2), (2, 2)], mode="reflect")
    nv = (w // 4) * 4
    r = _BLUR5[0] * p[..., 0:w]
    for j in range(1, 5):
        tap = p[..., j:j + w]
        k = np.float64(_BLUR5[j])
        r = np.concatenate([fma(k, tap[..., :nv], r[..., :nv]), r[..., nv:] + k * tap[..., nv:]],
                           -1)
    c = _BLUR5[2] * r[..., 2:2 + h, :]
    c = c + _BLUR5[1] * (r[..., 1:1 + h, :] + r[..., 3:3 + h, :])
    return c + _BLUR5[0] * (r[..., 0:h, :] + r[..., 4:4 + h, :])


def copy_make_border_constant(img: np.ndarray, top: int, bottom: int, left: int,
                              right: int, value) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=value)``: ``img`` on a canvas of ``value``
    (one value, or one a channel)."""
    h, w = img.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + img.shape[2:], img.dtype)
    out[...] = np.asarray(value, img.dtype)
    out[top:top + h, left:left + w] = img
    return out
