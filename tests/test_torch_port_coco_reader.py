"""The port's COCO readers and writers on the CPU against the JAX package:
``data/coco.py`` (StackGAN stages 1 and 2), ``data/attngan.py``'s JPEG
path, ``io/torchfile.py``, and the PIL-exact resizes of ``data/png.py``.

The readers decode with the port's numpy codec, which gives PIL's pixels,
so ``__getitem__`` is held bit for bit against the JAX reader's (PIL's
decode and bilinear resize) on JAX-written sets; ``get_batch`` too, and at
stage 2 within the ``atol 8.0`` the JAX package allows its own native
``get_batch`` (a two-tap resize). Sets the port writes read the same
through the JAX reader.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.data import attngan as jax_attngan
from multiple_objects_gan_tpu.data import coco as jax_coco
from multiple_objects_gan_tpu.io import torchfile as jax_t7
from multiple_objects_gan_tpu_torch.data import attngan as port_attngan
from multiple_objects_gan_tpu_torch.data import coco as port_coco
from multiple_objects_gan_tpu_torch.data import png
from multiple_objects_gan_tpu_torch.io import torchfile as port_t7

SEED = 5
N = 10


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """The JAX writer's COCO set: a train split of 10 and a test split of
    10, PIL's JPEGs."""
    root = tmp_path_factory.mktemp("jax_coco")
    data, imgs = str(root / "data"), str(root / "imgs")
    jax_coco.write_synthetic_coco(data, imgs, n=N, seed=SEED)
    jax_coco.write_synthetic_coco(data, imgs + "_test", n=N, split="test",
                                  seed=SEED + 1)
    return data, imgs


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        want, got = np.asarray(a[k]), np.asarray(b[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


STAGES = [(1, 64, True), (1, 64, False), (2, 256, True), (2, 256, False)]
STAGE_IDS = ["s1-crop", "s1-nocrop", "s2-crop", "s2-nocrop"]


@pytest.mark.parametrize("stage, imsize, crop", STAGES, ids=STAGE_IDS)
def test_getitem_equals_the_jax_reader_bit_for_bit(jax_set, stage, imsize,
                                                   crop):
    """Items in any order, revisits included: the image at 76/268 cropped
    and flipped, bbox (and stage 2's bbox_s2), one-hots and the drawn
    caption embedding, from one RandomState as the JAX reader draws."""
    data, imgs = jax_set
    j = jax_coco.CocoStackganDataset(data, imgs, stage=stage, imsize=imsize,
                                     crop=crop, seed=SEED)
    p = port_coco.CocoStackganDataset(data, imgs, stage=stage, imsize=imsize,
                                      crop=crop, seed=SEED)
    assert len(p) == len(j) == N
    for i in (0, 3, 9, 3, 7, 0):
        _equal(j[i], p[i])


@pytest.mark.parametrize("stage, imsize, crop", STAGES, ids=STAGE_IDS)
def test_get_batch_against_the_jax_reader(jax_set, stage, imsize, crop):
    """``get_batch`` equals JAX ``__getitem__`` stacked, bit for bit (the
    draws run in the same order), and JAX's native ``get_batch`` within the
    JAX package's own bound at stage 2 (its atol 8.0, an upsampling two-tap
    filter); boxes, one-hots and embeddings exactly."""
    data, imgs = jax_set
    idx = [4, 1, 8, 1]
    p = port_coco.CocoStackganDataset(data, imgs, stage=stage, imsize=imsize,
                                      crop=crop, seed=SEED)
    got = p.get_batch(idx)
    j = jax_coco.CocoStackganDataset(data, imgs, stage=stage, imsize=imsize,
                                     crop=crop, seed=SEED)
    items = [j[i] for i in idx]
    _equal({k: np.stack([it[k] for it in items]) for k in items[0]}, got)
    native = jax_coco.CocoStackganDataset(
        data, imgs, stage=stage, imsize=imsize, crop=crop,
        seed=SEED).get_batch(idx)
    for k in native:
        if k != "image":
            np.testing.assert_array_equal(got[k], native[k], err_msg=k)
    if stage == 2:
        np.testing.assert_allclose(got["image"].astype(np.float32),
                                   native["image"].astype(np.float32),
                                   atol=8.0)


def test_port_written_set_reads_the_same_through_both_readers(tmp_path):
    """The port's writer draws the JAX writer's stream (pickles equal, the
    t7 equal once loaded), its JPEGs decode under PIL to the pixels of the
    JAX writer's, and the JAX reader gives on it what the port's reader
    gives."""
    for who, writer in (("jax", jax_coco.write_synthetic_coco),
                        ("port", port_coco.write_synthetic_coco)):
        writer(str(tmp_path / who), str(tmp_path / f"{who}_imgs"), n=6,
               split="test", seed=3)
    for name in ("filenames", "bboxes", "labels", "char-CNN-RNN-embeddings"):
        with open(tmp_path / "jax" / "test" / f"{name}.pickle", "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "port" / "test" / f"{name}.pickle", "rb") as f:
            b = pickle.load(f)
        if isinstance(a, list):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    caps_j, emb_j = jax_t7.load_val_captions(
        str(tmp_path / "jax" / "test" / "val_captions.t7"))
    caps_p, emb_p = port_t7.load_val_captions(
        str(tmp_path / "port" / "test" / "val_captions.t7"))
    assert caps_j == caps_p
    np.testing.assert_array_equal(emb_j, emb_p)
    for f in sorted(os.listdir(tmp_path / "jax_imgs")):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port_imgs" / f)),
            np.asarray(Image.open(tmp_path / "jax_imgs" / f)), err_msg=f)
    data, imgs = str(tmp_path / "port"), str(tmp_path / "port_imgs")
    for stage, imsize in ((1, 64), (2, 256)):
        j = jax_coco.CocoStackganDataset(data, imgs, split="test",
                                         stage=stage, imsize=imsize, seed=2)
        p = port_coco.CocoStackganDataset(data, imgs, split="test",
                                          stage=stage, imsize=imsize, seed=2)
        for i in (5, 0, 2):
            _equal(j[i], p[i])


def test_rng_state_resumes_the_draws(jax_set):
    """A reader restored from another's ``rng_state`` draws what the first
    draws next (the checkpoint of a StackGAN run carries it)."""
    data, imgs = jax_set
    a = port_coco.CocoStackganDataset(data, imgs, stage=2, imsize=256,
                                      seed=SEED)
    a.get_batch([0, 1, 2])
    state = a.rng_state()
    b = port_coco.CocoStackganDataset(data, imgs, stage=2, imsize=256,
                                      seed=99)
    b.set_rng_state(state)
    _equal(a.get_batch([3, 4, 5]), b.get_batch([3, 4, 5]))


def test_a_missing_jpeg_raises_with_its_path(jax_set, tmp_path):
    data, imgs = jax_set
    p = port_coco.CocoStackganDataset(data, str(tmp_path), seed=SEED)
    with pytest.raises(FileNotFoundError, match="synthetic_000001.jpg"):
        p.get_batch([1])


@pytest.mark.parametrize("split", ["train", "test"])
def test_attngan_jpeg_path_equals_the_jax_reader(tmp_path, split):
    """AttnGanTrainSet on the JAX writer's JPEGs against JAX
    ``AttnGanDataset.__getitem__``: images at 64, 128 and 256, boxes,
    one-hots, captions, lengths and class ids, bit for bit; and on the port
    writer's set, which is the JAX writer's (pixels included)."""
    jdata, jimgs = str(tmp_path / "j"), str(tmp_path / "ji")
    pdata, pimgs = str(tmp_path / "p"), str(tmp_path / "pi")
    jax_attngan.write_synthetic_attngan(jdata, jimgs, n=8, seed=SEED)
    port_attngan.write_synthetic_attngan(pdata, pimgs, n=8, seed=SEED)
    names = sorted(os.listdir(jimgs))
    assert names == sorted(os.listdir(pimgs)) and len(names) == 8 + 4
    for f in names:
        np.testing.assert_array_equal(np.asarray(Image.open(
            os.path.join(pimgs, f))), np.asarray(Image.open(
                os.path.join(jimgs, f))), err_msg=f)
    idx = [1, 0, 3, 1]
    for data, imgs in ((jdata, jimgs), (pdata, pimgs)):
        j = jax_attngan.AttnGanDataset(data, imgs, split=split, words_num=5,
                                       seed=SEED)
        p = port_attngan.AttnGanTrainSet(data, imgs, words_num=5, seed=SEED,
                                         split=split)
        items = [j[i] for i in idx]
        got = p.get_batch(idx)
        want = {k: np.stack([it[k] for it in items]) for k in items[0]}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].astype(
                got[k].dtype), err_msg=k)


def test_attngan_text_side_alone_without_img_dir(tmp_path):
    """Without ``img_dir`` the writer writes the text side only (the
    service's vocabulary), from the same stream."""
    port_attngan.write_synthetic_attngan(str(tmp_path / "a"), n=8, seed=2)
    port_attngan.write_synthetic_attngan(str(tmp_path / "b"),
                                         str(tmp_path / "bi"), n=8, seed=2)
    for name in ("captions.pickle",):
        assert not (tmp_path / "a" / name).exists()
    assert sorted(os.listdir(tmp_path / "a" / "text")) == sorted(
        os.listdir(tmp_path / "b" / "text"))
    assert len(os.listdir(tmp_path / "bi")) == 8 + 4
    assert port_attngan.AttnGanDataset(str(tmp_path / "a")).n_words == \
        port_attngan.AttnGanDataset(str(tmp_path / "b")).n_words


@pytest.mark.parametrize("obj", [
    {b"raw_txt": [b"a caption", b"another"],
     b"fea_txt": [np.arange(6, dtype=np.float32).reshape(1, 6),
                  np.ones((2, 6), np.float32)]},
    [1.0, True, None, b"x", {b"k": np.zeros((3, 2), np.float64)}],
], ids=["val-captions", "mixed"])
def test_torchfile_load_and_save_against_jax(tmp_path, obj):
    """Files the port saves load in the JAX reader, and the JAX writer's in
    the port's, to the same objects."""
    def same(a, b):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b
    for save, load in ((port_t7.save, jax_t7.load),
                       (jax_t7.save, port_t7.load)):
        path = str(tmp_path / "f.t7")
        save(path, obj)
        same(jax_t7.load(path), load(path))
    with open(path, "rb") as f:
        blob = f.read()
    port_t7.save(path, obj)
    with open(path, "rb") as f:
        assert f.read() == blob


@pytest.mark.parametrize("src, dst", [
    ((96, 96), (256, 256)), ((268, 268), (64, 64)), ((100, 77), (64, 64)),
    ((31, 45), (256, 256)), ((268, 131), (76, 76)), ((17, 5), (3, 40))],
    ids=["96-256", "268-64", "100x77-64", "31x45-256", "268x131-76",
         "17x5-3x40"])
@pytest.mark.parametrize("resample, pil", [
    ("bilinear", Image.BILINEAR), ("lanczos", Image.LANCZOS)],
    ids=["bilinear", "lanczos"])
def test_resize_matches_pil_at_0_levels(src, dst, resample, pil):
    """Resample.c's bilinear and LANCZOS (support 3) filters, 8-bit fixed
    point; the batch and tensor forms of bilinear give the same."""
    rs = np.random.RandomState(sum(src) + sum(dst))
    a = rs.randint(0, 256, (2, *src, 3)).astype(np.uint8)
    size = (dst[1], dst[0])
    want = np.asarray(Image.fromarray(a[1]).resize(size, pil))
    np.testing.assert_array_equal(png.resize(a[1], size, resample), want)
    if resample == "bilinear":
        np.testing.assert_array_equal(png.resize_bilinear_batch(a, size)[1],
                                      want)
        np.testing.assert_array_equal(png.resize_bilinear_tensor(
            torch.from_numpy(a), size).numpy()[1], want)
