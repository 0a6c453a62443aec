"""The port's JPEG codec (``data/jpeg.py``) against PIL 12.1.0 and its
libjpeg-turbo, and the no-fallback rule of ``data/nvjpeg.py``.

The decoder is held at 0 levels against ``Image.open(p).convert("RGB")``
on the JAX writers' JPEGs and on PIL-written files of every kind it takes
(gray, 4:4:4, 4:2:2, 4:2:0, odd sizes, restart intervals, qualities); the
kinds it refuses raise ``ValueError`` naming the file. The encoder's files
decode, under PIL, to the pixels of PIL's own files from the same array.
On the card, a missing ``libnvjpeg`` raises: nothing gives way to the
numpy codec.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.data import attngan as jax_attngan
from multiple_objects_gan_tpu.data import coco as jax_coco
from multiple_objects_gan_tpu_torch.data import jpeg, nvjpeg


def _image(shape, seed):
    """Dark noise with bright rectangles and a red ramp: sharp chroma
    edges and smooth gradients, as the synthetic sets have."""
    rs = np.random.RandomState(seed)
    h, w = shape[:2]
    x = (rs.rand(h, w, 3) * 40).astype(np.uint8)
    for _ in range(3):
        y0, x0 = rs.randint(0, max(1, h // 2)), rs.randint(0, max(1, w // 2))
        x[y0:y0 + max(1, h // 3), x0:x0 + max(1, w // 3)] = rs.randint(
            0, 256, 3)
    x[..., 0] = x[..., 0] // 2 + (np.arange(w)[None] * 100 // max(w, 1)
                                  ).astype(np.uint8)
    return x if len(shape) == 3 else np.ascontiguousarray(x[..., 1])


def _pil_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_decoder_matches_pil_on_the_jax_writers_jpegs(tmp_path):
    """Every JPEG of the JAX package's COCO and AttnGAN writers (PIL's
    encoder at its defaults: 96x96 and 268x268, 4:2:0) decodes to PIL's
    pixels exactly."""
    jax_coco.write_synthetic_coco(str(tmp_path / "c"), str(tmp_path / "ci"),
                                  n=6, seed=1)
    jax_attngan.write_synthetic_attngan(str(tmp_path / "a"),
                                        str(tmp_path / "ai"), n=4, seed=1)
    paths = [os.path.join(d, f) for d in (tmp_path / "ci", tmp_path / "ai")
             for f in sorted(os.listdir(d))]
    assert len(paths) == 6 + 4 + 4
    for p in paths:
        got = jpeg.read_jpeg(p)
        want = np.asarray(Image.open(p).convert("RGB"))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=p)


@pytest.mark.parametrize("shape, kw", [
    ((64, 64), {}),
    ((31, 45), {"quality": 90}),
    ((96, 96, 3), {"subsampling": 0}),
    ((50, 50, 3), {"subsampling": 1}),
    ((96, 96, 3), {}),
    ((268, 268, 3), {}),
    ((17, 33, 3), {}),
    ((100, 77, 3), {"subsampling": 1}),
    ((1, 1, 3), {}),
    ((2, 40, 3), {}),
    ((40, 2, 3), {"subsampling": 0}),
    ((96, 96, 3), {"restart_marker_blocks": 3}),
    ((67, 90, 3), {"restart_marker_rows": 1, "quality": 10}),
    ((33, 65, 3), {"quality": 100}),
], ids=["gray", "gray-odd", "444", "422", "420", "420-268", "420-odd",
        "422-odd", "1x1", "2x40", "40x2-444", "restart-blocks",
        "restart-rows-q10", "q100-odd"])
def test_decoder_matches_pil_at_0_levels(shape, kw):
    arr = _image(shape, seed=sum(shape))
    data = _pil_bytes(arr, **kw)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_rgb(data))


def _cmyk(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _patched(data, old, new):
    assert old in data
    return data.replace(old, new, 1)


@pytest.mark.parametrize("kind, make, message", [
    ("progressive", lambda a: _pil_bytes(a, progressive=True),
     "progressive"),
    ("cmyk", _cmyk, "4 components"),
    ("12-bit", lambda a: _patched(_pil_bytes(a), b"\xff\xc0\x00\x11\x08",
                                  b"\xff\xc0\x00\x11\x0c"), "12-bit"),
    ("arithmetic", lambda a: _patched(_pil_bytes(a), b"\xff\xc0",
                                      b"\xff\xc9"), "arithmetic"),
    ("truncated", lambda a: _pil_bytes(a)[:-2], "truncated"),
    ("not-jpeg", lambda a: b"\x89PNG\r\n\x1a\n" + bytes(40), "not a JPEG"),
])
def test_refused_kinds_raise_naming_the_file(tmp_path, kind, make, message):
    """Files the codec does not take raise ValueError with the path, from
    the decoder and from the marker walk the card runs before nvjpeg."""
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(make(_image((40, 48, 3), seed=3)))
    with pytest.raises(ValueError, match=message) as e:
        jpeg.read_jpeg(path)
    assert path in str(e.value)
    with open(path, "rb") as f:
        with pytest.raises(ValueError, match=message):
            jpeg.probe_jpeg(f.read(), path)


def test_corrupt_entropy_data_raises():
    """A scan cut short and closed with an EOI: the Huffman decoder finds
    no code and raises, where libjpeg warns and fills the rest (the reader
    leaves no made-up pixels)."""
    data = _pil_bytes(_image((64, 64, 3), seed=5))
    broken = data[:len(data) // 2] + b"\xff\xd9"
    with pytest.raises(ValueError, match="corrupt JPEG data"):
        jpeg.decode_jpeg(broken, "cut")


@pytest.mark.parametrize("shape, quality, sub, pil_sub", [
    ((96, 96, 3), 75, "4:2:0", -1),
    ((268, 268, 3), 75, "4:2:0", -1),
    ((17, 33, 3), 75, "4:2:0", -1),
    ((33, 17, 3), 30, "4:2:0", -1),
    ((65, 49, 3), 95, "4:2:0", -1),
    ((40, 40, 3), 75, "4:4:4", 0),
    ((41, 23, 3), 75, "4:2:2", 1),
    ((1, 1, 3), 75, "4:2:0", -1),
    ((64, 64), 75, "4:2:0", -1),
    ((31, 45), 50, "4:2:0", -1),
], ids=["96", "268", "17x33", "33x17-q30", "65x49-q95", "444", "422-odd",
        "1x1", "gray", "gray-odd-q50"])
@pytest.mark.parametrize("noise", [False, True], ids=["scene", "noise"])
def test_encoder_files_decode_like_pils_own(shape, quality, sub, pil_sub,
                                           noise):
    """The port's encoder gives PIL's quantized coefficients: its file
    decodes, under PIL, to the pixels of the file PIL writes from the same
    array (quality, subsampling; header bytes may differ), and the port's
    decoder reads it back to the same pixels."""
    arr = (np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
           if noise else _image(shape, seed=11))
    kw = {"quality": quality}
    if pil_sub >= 0:
        kw["subsampling"] = pil_sub
    ours = jpeg.encode_jpeg(arr, quality=quality, subsampling=sub)
    np.testing.assert_array_equal(_pil_rgb(ours), _pil_rgb(_pil_bytes(arr,
                                                                     **kw)))
    np.testing.assert_array_equal(jpeg.decode_jpeg(ours), _pil_rgb(ours))


def test_probe_reads_size_and_components():
    assert jpeg.probe_jpeg(_pil_bytes(_image((21, 34, 3), 1))) == (21, 34, 3)
    assert jpeg.probe_jpeg(_pil_bytes(_image((9, 7), 1))) == (9, 7, 1)


def test_fancy_false_replicates_chroma():
    """``fancy=False`` is libjpeg's box upsampling: on a 4:4:4 file it
    changes nothing, on a 4:2:0 file each chroma sample covers 2x2
    pixels."""
    arr = _image((32, 32, 3), seed=2)
    f444 = _pil_bytes(arr, subsampling=0)
    np.testing.assert_array_equal(jpeg.decode_jpeg(f444, fancy=False),
                                  jpeg.decode_jpeg(f444))
    f420 = _pil_bytes(arr)
    assert not np.array_equal(jpeg.decode_jpeg(f420, fancy=False),
                              jpeg.decode_jpeg(f420))


@pytest.fixture
def no_nvjpeg(monkeypatch):
    """A machine whose CUDA toolkit has no libnvjpeg."""
    monkeypatch.setattr(nvjpeg, "library_candidates", lambda: [])
    monkeypatch.setattr(nvjpeg, "_lib", None)
    monkeypatch.setattr(nvjpeg, "_handle", None)


def test_nvjpeg_without_the_library_raises_with_no_fallback(tmp_path,
                                                            no_nvjpeg):
    """device=cuda goes to nvjpeg alone: without the library it raises
    (the numpy codec is not tried), and the CPU path still decodes."""
    path = str(tmp_path / "a.jpg")
    arr = _image((24, 24, 3), seed=4)
    with open(path, "wb") as f:
        f.write(_pil_bytes(arr))
    with pytest.raises(nvjpeg.NvjpegError, match="libnvjpeg.so.12 not found"):
        nvjpeg.decode_batch([path], "cuda")
    with pytest.raises(nvjpeg.NvjpegError, match="libnvjpeg.so.12 not found"):
        nvjpeg.encode(str(tmp_path / "b.jpg"), arr, "cuda")
    assert not os.path.exists(tmp_path / "b.jpg")
    got = nvjpeg.decode_batch([path], "cpu")
    np.testing.assert_array_equal(got[0], np.asarray(Image.open(path)))


def test_nvjpeg_refuses_a_bad_file_before_the_library(tmp_path, no_nvjpeg):
    """On the card a file the codec refuses raises ValueError with its
    name from the marker walk, before nvjpeg is loaded."""
    path = str(tmp_path / "p.jpg")
    with open(path, "wb") as f:
        f.write(_pil_bytes(_image((24, 24, 3), 4), progressive=True))
    with pytest.raises(ValueError, match="progressive"):
        nvjpeg.decode_batch([path], "cuda")


def test_cpu_encode_and_decode_resized_match_pil(tmp_path):
    """``encode`` on the CPU writes the port's encoder's file, and
    ``decode_resized`` is PIL's open, convert and bilinear resize."""
    arr = _image((96, 96, 3), seed=9)
    path = str(tmp_path / "x.jpg")
    nvjpeg.encode(path, arr, "cpu")
    assert open(path, "rb").read() == jpeg.encode_jpeg(arr)
    for size in (76, 96, 268):
        got = nvjpeg.decode_resized([path, path], size, "cpu")
        want = np.asarray(Image.open(path).convert("RGB").resize(
            (size, size), Image.BILINEAR))
        assert got.shape == (2, size, size, 3)
        np.testing.assert_array_equal(got[1], want)
    assert isinstance(torch.from_numpy(got), torch.Tensor)
