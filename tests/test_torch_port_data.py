"""The port's data path (multiple_objects_gan_tpu_torch: ``data/png.py``,
``data/datasets.py``, ``io/pycompat.py:load_pickle`` and the grids of
``utils/images.py``) against PIL and the JAX package, on the CPU.

Every input is drawn from a numpy seed. Tolerances, all exact:

* PNG decode: bit for bit against PIL's ``Image.open().convert()`` for
  PNGs PIL writes (L, RGB, RGBA, palette) and for PNGs built by hand with
  each of the five row filters;
* resize: 0 levels of 255 against PIL's ``resize(BILINEAR)``, 480x320 ->
  64x64 among the cases;
* datasets and loaders: items and batches bit for bit against the JAX
  readers, over two epochs with CLEVR's h-flip;
* grids and box outlines: bit for bit against the JAX ``make_grid`` and
  ``draw_bboxes``. Caption text is the port's own font, so its tile is
  held by layout: white outside the text box, dark pixels inside.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.data import datasets as jds
from multiple_objects_gan_tpu.io import pycompat as jpycompat
from multiple_objects_gan_tpu.utils import images as jimages
from multiple_objects_gan_tpu_torch.data import datasets as pds
from multiple_objects_gan_tpu_torch.data import png
from multiple_objects_gan_tpu_torch.io import pycompat as ppycompat
from multiple_objects_gan_tpu_torch.utils import images as pimages
from chip_smoke import filtered_png
from test_pycompat import write_py2_pickle
from test_torch_port_serve import _imported_roots

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _smooth(h, w, c, seed):
    """Gradients with noise: the rows PIL's adaptive filter picks differ."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * (k + 2) + yy * (3 - k)) % 256 for k in range(c)]
    x = np.stack(planes, -1) + rs.randint(-6, 7, (h, w, c))
    return np.clip(x, 0, 255).astype(np.uint8)


def _pil_bytes(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


def _pil_decode(data: bytes, mode: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


# ------------------------------------------------------------- PNG decode


def _pil_image(kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "L":
        return Image.fromarray(_smooth(23, 41, 1, seed)[..., 0], "L")
    if kind == "RGB":
        return Image.fromarray(_smooth(23, 41, 3, seed), "RGB")
    if kind == "RGBA":
        return Image.fromarray(_smooth(23, 41, 4, seed), "RGBA")
    im = Image.fromarray(rs.randint(0, 256, (23, 41), np.uint8), "P")
    im.putpalette(rs.randint(0, 256, 768, np.uint8).tobytes())
    return im                                  # 256 entries: 8-bit indices


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "P"])
def test_decode_equals_pil_for_pngs_pil_writes(kind, mode):
    data = _pil_bytes(_pil_image(kind, seed=len(kind)))
    got = png.convert(*png.decode_png(data), mode)
    want = _pil_decode(data, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype, channels", [(0, 1), (2, 3), (3, 1), (6, 4)],
                         ids=["gray", "rgb", "palette", "rgba"])
@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_decode_each_row_filter_equals_pil(row_filter, ctype, channels):
    """Every row written with one filter, and a file cycling through all
    five, decode as PIL decodes them."""
    pixels = _smooth(19, 27, channels, seed=row_filter)
    palette = None
    if ctype == 3:
        palette = np.random.RandomState(5).randint(0, 256, (256, 3))
    for filters in ([row_filter], [row_filter, 0, 1, 2, 3, 4]):
        data = filtered_png(pixels, ctype, filters, palette)
        for mode in ("L", "RGB"):
            got = png.convert(*png.decode_png(data), mode)
            np.testing.assert_array_equal(got, _pil_decode(data, mode))
    raw, _, _ = png.decode_png(filtered_png(pixels, ctype, [row_filter],
                                            palette))
    np.testing.assert_array_equal(raw, pixels)


def _ihdr_png(depth, ctype, interlace, body=b"\x00" * 4):
    def chunk(kind, data):
        crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", crc)
    return (png.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("data, message", [
    (_ihdr_png(16, 0, 0), "bit depth 16"),
    (_ihdr_png(4, 3, 0), "bit depth 4"),
    (_ihdr_png(8, 4, 0), "colour type 4"),
    (_ihdr_png(8, 0, 1), "interlaced"),
    (_ihdr_png(8, 0, 0)[:-5] + b"\x00" * 5, "CRC"),
    (b"GIF89a" + b"\x00" * 20, "signature"),
], ids=["16-bit", "4-bit-palette", "gray-alpha", "interlaced", "bad-crc",
        "not-png"])
def test_unsupported_pngs_raise(data, message):
    with pytest.raises(ValueError, match=message):
        png.decode_png(data)


def test_read_png_reads_the_files_of_the_port_writer(tmp_path):
    rgb = _smooth(64, 64, 3, seed=9)
    path = tmp_path / "a.png"
    path.write_bytes(pimages.png_bytes(rgb))
    np.testing.assert_array_equal(png.read_png(str(path), "RGB"), rgb)
    np.testing.assert_array_equal(png.read_png(str(path), "L"),
                                  np.asarray(Image.open(path).convert("L")))


# ----------------------------------------------------------------- resize


@pytest.mark.parametrize("src, dst", [
    ((480, 320), (64, 64)), ((64, 64), (64, 64)), ((50, 40), (64, 30)),
    ((33, 77), (64, 64)), ((64, 130), (64, 64))],
    ids=["clevr-480x320", "same", "up-down", "odd", "rows-only"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_pil_bilinear(src, dst, channels):
    """0 levels of 255 from PIL's Image.resize(size, Image.BILINEAR)."""
    img = _smooth(src[1], src[0], channels, seed=src[0])
    img = img[..., 0] if channels == 1 else img
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    got = png.resize_bilinear(img, dst)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the datasets


def _items(ds, n):
    return [ds[i] for i in range(n)]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Each writer's Multi-MNIST and CLEVR sets: the port's and JAX's."""
    root = tmp_path_factory.mktemp("sets")
    out = {}
    for side, mod in (("port", pds), ("jax", jds)):
        d = str(root / side)
        mod.write_synthetic_multimnist(d, n=24, seed=3)
        mod.write_synthetic_clevr(d, n=24, seed=3)
        out[side] = d
    return out


def test_port_written_sets_read_by_the_jax_readers_give_the_jax_items(sets):
    _assert_items_equal(_items(jds.MultiMnistDataset(sets["port"]), 24),
                        _items(jds.MultiMnistDataset(sets["jax"]), 24))
    _assert_items_equal(
        _items(jds.ClevrDataset(sets["port"], hflip=False), 24),
        _items(jds.ClevrDataset(sets["jax"], hflip=False), 24))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_port_readers_give_the_jax_readers_items(sets, side):
    _assert_items_equal(_items(pds.MultiMnistDataset(sets[side]), 24),
                        _items(jds.MultiMnistDataset(sets[side]), 24))
    _assert_items_equal(_items(pds.ClevrDataset(sets[side], seed=4), 24),
                        _items(jds.ClevrDataset(sets[side], seed=4), 24))


@pytest.mark.parametrize("variant", ["clevr", "multi-mnist"])
def test_port_loader_gives_the_jax_loaders_batches(sets, variant):
    """Two epochs, shuffled from seed + epoch, drop-last, CLEVR's flips
    drawn in the loader's order."""
    if variant == "clevr":
        port_ds = pds.ClevrDataset(sets["jax"], hflip=True, seed=11)
        jax_ds = jds.ClevrDataset(sets["jax"], hflip=True, seed=11)
    else:
        port_ds = pds.MultiMnistDataset(sets["jax"])
        jax_ds = jds.MultiMnistDataset(sets["jax"])
    port, jax_loader = pds.Loader(port_ds, 5, seed=2), jds.Loader(jax_ds, 5,
                                                                  seed=2)
    assert len(port) == len(jax_loader) == 4
    flips = 0
    for epoch in range(2):
        got, want = list(port.epoch(epoch)), list(jax_loader.epoch(epoch))
        _assert_items_equal(got, want)
        if variant == "clevr":
            plain = [pds.ClevrDataset(sets["jax"], hflip=False)[i]["bbox"]
                     for i in range(24)]
            flips += sum(int(not any(np.array_equal(b, p) for p in plain))
                         for batch in got for b in batch["bbox"])
    assert variant != "clevr" or 0 < flips < 40


def test_loader_raises_the_workers_error_in_the_consumer():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5")
            return {"x": np.zeros(2)}

    with pytest.raises(KeyError, match="item 5"):
        list(pds.Loader(Broken(), 4).epoch(0))


def test_memory_loader_orders_as_the_loader_and_draws_captions():
    n, bs = 10, 4
    data = {"image": np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1),
            "bbox": np.zeros((n, 3, 4), np.float32),
            "label_onehot": np.zeros((n, 3, 81), np.float32),
            "text_embedding": np.arange(n * 5, dtype=np.float32).reshape(
                n, 5, 1)}
    loader = pds.MemoryLoader(data, bs, seed=6)
    rng = np.random.RandomState(6)
    for epoch in range(2):
        order = np.arange(n)
        np.random.RandomState(6 + epoch).shuffle(order)
        pick = rng.randint(5, size=n)
        batches = list(loader.epoch(epoch))
        assert len(batches) == n // bs
        idx = torch.cat([b["image"].flatten() for b in batches]).numpy()
        np.testing.assert_array_equal(idx, order[:8])
        text = torch.cat([b["text_embedding"].flatten()
                          for b in batches]).numpy()
        np.testing.assert_array_equal(text, (idx * 5 + pick[idx]))


# ------------------------------------------------------- Python-2 pickles


@pytest.mark.parametrize("obj", [
    np.array([[0.1, -2.5, 3.25], [1e-3, 7.0, -0.0]], np.float32),
    np.arange(-4, 8, dtype=np.int64).reshape(3, 4),
    [b"caf\xe9_0001.png", b"img_0002.png"],
    [[1, 2], {1: b"a", 2: b"caf\xc3\xa9"}],
], ids=["float32", "int64", "latin1-names", "utf8-text"])
def test_py2_pickles_load_as_the_jax_load_pickle_loads_them(tmp_path, obj):
    path = str(tmp_path / "a.pickle")
    write_py2_pickle(path, obj)
    got, stage = ppycompat.load_pickle_diag(path)
    want, want_stage = jpycompat.load_pickle_diag(path)
    assert stage == want_stage
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    with open(tmp_path / "py3.pickle", "wb") as f:
        pickle.dump({"a": obj}, f)
    assert ppycompat.load_pickle_diag(str(tmp_path / "py3.pickle"))[1] == \
        "py3"


def test_multimnist_reader_takes_py2_pickles(sets, tmp_path):
    """The published Multi-MNIST pickles are Python-2 cPickle files."""
    src = os.path.join(sets["jax"], "train", "normal")
    dst = tmp_path / "train" / "normal"
    os.makedirs(dst)
    os.symlink(os.path.join(src, "imgs"), dst / "imgs")
    for key in ("filenames", "bboxes", "labels"):
        obj = jpycompat.load_pickle(os.path.join(src, f"{key}.pickle"))
        if key == "filenames":
            obj = [name.encode() for name in obj]
        write_py2_pickle(str(dst / f"{key}.pickle"), obj)
    _assert_items_equal(_items(pds.MultiMnistDataset(str(tmp_path)), 24),
                        _items(jds.MultiMnistDataset(sets["jax"]), 24))


# ------------------------------------------------------------------ grids


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("channels", [1, 3])
def test_make_grid_equals_the_jax_grid(dtype, channels):
    rs = np.random.RandomState(channels)
    if dtype == "uint8":
        x = rs.randint(0, 256, (11, 9, 7, channels)).astype(np.uint8)
    else:
        x = rs.uniform(-1.3, 1.3, (11, 9, 7, channels)).astype(np.float32)
    for nrow in (4, 10):
        np.testing.assert_array_equal(pimages.make_grid(x, nrow=nrow),
                                      jimages.make_grid(x, nrow=nrow))


def test_save_grid_writes_the_jax_grid_pixels(tmp_path):
    x = np.random.RandomState(0).uniform(-1, 1, (20, 8, 8, 3)).astype(
        np.float32)
    pimages.save_grid(x, str(tmp_path / "p" / "g.png"), nrow=10)
    jimages.save_grid(x, str(tmp_path / "j.png"), nrow=10)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "p" / "g.png")),
        np.asarray(Image.open(tmp_path / "j.png")))


def test_draw_bboxes_equals_the_jax_outlines():
    img = np.random.RandomState(1).randint(0, 256, (64, 48, 3)).astype(
        np.uint8)
    bb = np.array([[0.1, 0.2, 0.3, 0.4], [-1, -1, -1, -1],
                   [0.5, 0.5, 0.6, 0.7], [0.0, 0.0, 1.0, 1.0],
                   [0.33, 0.71, 0.2, 0.05]], np.float32)
    got = pimages.draw_bboxes(img, bb)
    np.testing.assert_array_equal(got, jimages.draw_bboxes(img, bb))
    assert not np.array_equal(got, img)


def test_caption_tile_is_white_outside_its_text_and_dark_inside():
    tile = pimages.caption_tile(["red cube", "7, ?"], (40, 64))
    ink = (tile < 128).all(-1)
    assert ink.any()
    rows, cols = np.nonzero(ink)
    # two lines from (2, 2), 11 rows apart, 7-row glyphs 6 columns apart
    assert rows.min() >= 2 and rows.max() < 2 + 11 + 7
    assert cols.min() >= 2 and cols.max() < 2 + 6 * len("red cube")
    assert (tile[~ink] == 255).all()


def test_the_port_imports_no_imaging_or_yaml_library():
    """PIL, PyYAML and torchvision are not on the card's machine."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT,
                                            "multiple_objects_gan_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = [(p, m) for p in files for m in _imported_roots(p)
                 if m in ("PIL", "yaml", "torchvision")]
    assert not offenders
