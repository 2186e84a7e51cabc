"""The RektNet disk dataset (``data/rektnet_data.py``, ``ops/heatmap.py``'s
host targets, ``data/decode.imread_bgr``) against the JAX package's, on
PNG crops written here: the label CSV's split, names and labels (NaN rows,
short and undecodable images skipped), every ``ConeDataset`` item (BGR
image, heatmaps, points, name, original shape), ``prep_image``,
``prep_label``, ``get_scale`` and ``scale_keypoints``. Tolerance: none —
the heatmaps too are bit-equal (the port's resize and blur are OpenCV's,
fused multiply-adds included)."""

import contextlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from mit_driverless_cv_traininginfra_tpu.data import rektnet_data as jdata
from mit_driverless_cv_traininginfra_tpu.ops import heatmap as jheat
from mit_driverless_cv_traininginfra_tpu_torch.data import decode, rektnet_data, synthetic
from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader
from mit_driverless_cv_traininginfra_tpu_torch.ops import heatmap


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    """Cone crops of 10-200 px as PNG with a label CSV: a NaN-labelled row,
    a 9-px-tall image, a file that is not an image, a keypoint on a
    border pixel."""
    d = tmp_path_factory.mktemp("rk")
    rng = np.random.default_rng(3)
    keys = rektnet_data.DEFAULT_KEYPOINT_KEYS
    # the columns in another order than the keypoints: looked up by name
    header = ["image", "url"] + keys[::-1]
    lines = [",".join(header)]
    sizes = [10, 23, 64, 80, 97, 120, 159, 160, 161, 200, 45, 71]
    for i, size in enumerate(sizes):
        w = int(size * rng.uniform(0.6, 1.0)) if i % 3 else size
        img, pts = synthetic.cone_crop(rng, size=size)
        img = np.ascontiguousarray((img[:, :w] * 255).astype(np.uint8))
        px = np.clip(pts * [w, size], 0, [w - 1, size - 1])
        if i == 4:
            px[0] = [w - 1, size - 1]
        name = f"c{i:02d}.png"
        Image.fromarray(img).save(d / name)
        cells = {k: f'"({p[0]:.2f},{p[1]:.2f})"' for k, p in zip(keys, px)}
        lines.append(",".join([name, "local"] + [cells[k] for k in header[2:]]))
    Image.fromarray(np.zeros((9, 30, 3), np.uint8)).save(d / "short.png")
    (d / "bad.png").write_bytes(b"not an image")
    cells = ",".join(['"(1.00,2.00)"'] * 7)
    lines.insert(3, f"short.png,local,{cells}")
    lines.insert(5, f"bad.png,local,{cells}")
    lines.insert(7, "nan.png,local," + ",".join([""] * 7))
    (d / "label.csv").write_text("\n".join(lines) + "\n")
    return d


def test_split_names_and_labels_equal_jax(crops, tmp_path):
    for ratio in (0.0, 0.25, 0.5):
        j = _quiet(jdata.load_train_csv_dataset, str(crops / "label.csv"), ratio,
                   dataset_path=str(crops))
        p = _quiet(rektnet_data.load_train_csv_dataset, str(crops / "label.csv"), ratio,
                   dataset_path=str(crops), cache_location=str(tmp_path))
        for a, b in zip(j, p):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    # a second read comes from the port's own cache folder
    cached = _quiet(rektnet_data.load_train_csv_dataset, str(crops / "label.csv"), 0.5,
                    dataset_path=str(crops), cache_location=str(tmp_path))
    assert [f.startswith("csv-sha256-") for f in os.listdir(tmp_path)] == [True]
    for a, b in zip(j, cached):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert "short.png" not in p[0] and "bad.png" not in p[0] and len(p[0]) + len(p[2]) == 12


def test_cone_dataset_items_bit_equal_to_jax(crops):
    names, labels, _, _ = _quiet(jdata.load_train_csv_dataset, str(crops / "label.csv"), 0.0,
                                 dataset_path=str(crops))
    for heat in (True, False):
        jds = jdata.ConeDataset(names, labels, str(crops), (80, 80), compute_heatmaps=heat)
        pds = rektnet_data.ConeDataset(names, labels, str(crops), (80, 80),
                                       compute_heatmaps=heat)
        for i in range(len(names)):
            a, b = _quiet(jds.__getitem__, i), _quiet(pds.__getitem__, i)
            for x, y in zip(a, b):
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), (i, names[i])
                else:
                    assert x == y
    jb = list(jdata.RektNetLoader(jds, 5, num_workers=2))
    pb = list(DataLoader(pds, 5, shuffle=False, num_workers=2,
                         collate=rektnet_data.collate_cones))
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def test_host_targets_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    for h, w in [(10, 10), (45, 120), (160, 160), (200, 13), (81, 80)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert np.array_equal(heatmap.prep_image(img, (80, 80)), jheat.prep_image(img, (80, 80)))
        label = rng.uniform(0, 1, (7, 2)) * [w - 1, h - 1]
        label[0] = [w - 1, h - 1]
        a = _quiet(jheat.prep_label, label, (80, 80), (h, w, 3))
        b = _quiet(heatmap.prep_label, label, (80, 80), (h, w, 3))
        assert np.array_equal(a, b)
        hs, ws = heatmap.get_scale((h, w, 3), (80, 80))
        assert (hs, ws) == jheat.get_scale((h, w, 3), (80, 80))
        assert np.array_equal(heatmap.scale_keypoints(label, hs, ws),
                              jheat.scale_keypoints(label, hs, ws))


def test_a_map_that_sums_to_zero_warns_and_stays():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        # a one-hot resized away entirely: 1 px of a 1000-px-wide map
        hm = heatmap.prep_label(np.array([[999.0, 0.0]]), (4, 4), (1, 1000), "x.png")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = jheat.prep_label(np.array([[999.0, 0.0]]), (4, 4), (1, 1000), "x.png")
    assert np.array_equal(hm, ref)
    assert ("Incorrect Data Label" in out.getvalue()) == (ref.sum() == 0)


def test_imread_bgr(crops, tmp_path):
    img = decode.imread_bgr(str(crops / "c02.png"))
    assert np.array_equal(img, np.asarray(Image.open(crops / "c02.png"))[..., ::-1])
    rgb = np.random.default_rng(0).integers(0, 256, (12, 11, 3), dtype=np.uint8)
    np.save(tmp_path / "x.npy", rgb)
    assert np.array_equal(decode.imread_bgr(str(tmp_path / "x.npy")), rgb[..., ::-1])
    assert decode.imread_bgr(str(crops / "bad.png")) is None
    assert decode.imread_bgr(str(tmp_path / "missing.png")) is None
