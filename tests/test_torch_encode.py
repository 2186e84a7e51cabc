"""``data/encode.py``: the port's JPEG and PNG writers, read back with
PIL. PNG exactly; baseline JPEG at OpenCV's default quality 95 at PSNR
≥ 35 dB on a rendered cone scene and crop (and well-formed at PIL's 75,
on noise, in grey and at sizes that are not multiples of 8). The Huffman
tables are the standard ones: every run/size symbol once."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from mit_driverless_cv_traininginfra_tpu_torch.data import encode, synthetic


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / ((a.astype(float) - b.astype(float)) ** 2).mean())


def _images():
    rng = np.random.default_rng(0)
    scene, _ = synthetic.cone_scene(rng, size=200)
    crop, _ = synthetic.cone_crop(rng, size=97)
    return [(scene * 255).astype(np.uint8), (crop * 255).astype(np.uint8)]


def test_huffman_tables_hold_every_symbol_once():
    symbols = {0x00, 0xF0} | {(r << 4) | s for r in range(16) for s in range(1, 11)}
    for bits, vals in (encode._AC_LUMA, encode._AC_CHROMA):
        assert sum(bits) == len(vals) == 162 and set(vals) == symbols
    for bits, vals in (encode._DC_LUMA, encode._DC_CHROMA):
        assert sum(bits) == len(vals) == 12


@pytest.mark.parametrize("which", [0, 1])
def test_jpeg_decodes_at_35_db(which):
    img = _images()[which]
    for arr in (img, img[..., 1]):
        back = np.asarray(Image.open(io.BytesIO(encode.encode_jpeg(arr, encode.CV2_QUALITY))))
        assert back.shape == arr.shape
        assert _psnr(back, arr) >= 35.0


def test_jpeg_is_well_formed_on_noise_and_odd_sizes():
    rng = np.random.default_rng(1)
    for shape in [(37, 53, 3), (8, 8, 3), (1, 1, 3), (9, 17)]:
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        for q in (encode.PIL_QUALITY, encode.CV2_QUALITY, 100):
            data = encode.encode_jpeg(arr, q)
            assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
            back = np.asarray(Image.open(io.BytesIO(data)))
            assert back.shape == arr.shape
    arr = np.full((64, 64, 3), 200, np.uint8)
    back = np.asarray(Image.open(io.BytesIO(encode.encode_jpeg(arr)))).astype(int)
    assert np.abs(back - arr).max() <= 1


def test_png_decodes_exactly():
    rng = np.random.default_rng(2)
    for arr in _images() + [rng.integers(0, 256, (13, 7), dtype=np.uint8)]:
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(encode.encode_png(arr)))), arr)


def test_write_image_by_extension(tmp_path):
    img = _images()[1]
    for name in ("a.png", "a.jpg", "a.JPEG", "a.npy"):
        path = encode.write_image(str(tmp_path / name), img)
        assert os.listdir(tmp_path).count(name) == 1
        if name.endswith(".npy"):
            assert np.array_equal(np.load(path), img)
        else:
            assert Image.open(path).size == (img.shape[1], img.shape[0])
    assert sorted(os.listdir(tmp_path)) == ["a.JPEG", "a.jpg", "a.npy", "a.png"]
