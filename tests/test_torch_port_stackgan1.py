"""The port's COCO StackGAN stage 1 (multiple_objects_gan_tpu_torch: the CA
net, the label embedding of [c || one-hot], the mu condition, the KL term
of the step, the synthetic set, the train entry and the service) against
the JAX package, on the CPU.

The checks and their tolerances are tests/test_torch_port_clevr.py's
(whose helpers this file calls): forwards at gf/df 8 and batch 4 at 2e-5,
the train-mode ones also against the port in float64; the label
embedding's running statistics at 1e-6; one train step with ``kl_loss``
at the criteria of tests/test_torch_port_step.py, the CA eps replayed from
the JAX step's ``rng_ca`` as tests/test_step_parity.py:87-93 replays z;
the trained ``runs_r5/stackgan1_repin/netG_final.pth`` at 2e-4. The CA
net is held with its eps injected.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.data.coco import (
    labels_to_onehot, write_synthetic_coco)
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.nn.pathways import CANet as JCANet
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config, train_settings)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_coco
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import Stage1G
from multiple_objects_gan_tpu_torch.nn.pathways import CANet
from test_torch_port_clevr import (
    ROOT, Server, _close, check_cli_epoch, check_d_forward,
    check_eval_forward, check_label_embed_statistics, check_one_step,
    check_train_forward, check_trained_checkpoint, jax_nets, tiny_cfg)
from test_torch_port_stage1g import _randomize

B = 4
JCFG = dataclasses.replace(jcommon.COCO_S1, gf_dim=8, df_dim=8)
PCFG = dataclasses.replace(common.COCO_S1, gf_dim=8, df_dim=8)
CKPT = os.path.join(ROOT, "runs_r5", "stackgan1_repin", "netG_final.pth")
KL_COEFF = 2.0      # cfg/coco_s1_train.yml TRAIN.COEFF.KL


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


def coco_batch(seed: int, b: int = B) -> dict:
    """b items of the synthetic COCO set (1-3 objects, padded ones -1 and
    one-hot in slot 80), each with its first caption embedding, the first
    box moved partly off the canvas, and z."""
    data = synthetic_coco(b, seed=seed)
    data["text_embedding"] = data["text_embedding"][:, 0].copy()
    data["bbox"][0, 0, 0] = -0.1
    data["z"] = np.random.RandomState(seed + 1).randn(
        b, PCFG.z_dim).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def nets():
    return jax_nets(JCFG, 14)


def test_eval_forward_matches_jax_sample_fn(nets):
    """c = mu in eval, as the JAX sampling without a CA rng."""
    check_eval_forward(JCFG, PCFG, nets, coco_batch(15))


def test_train_forward_matches_jax(nets):
    """The train-mode image, mu and logvar, and the running statistics,
    with the JAX CA net's eps replayed."""
    check_train_forward(JCFG, PCFG, nets, coco_batch(16))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_and_both_heads_match_jax(nets, train):
    """D's object pathway keeps the raw one-hots (3 + 81 input channels);
    its conditional head takes a 128-d mu."""
    data = coco_batch(17)
    mu = np.random.RandomState(18).randn(B, JCFG.condition_dim).astype(
        np.float32)
    check_d_forward(JCFG, PCFG, nets, data, mu, train)


def test_label_embed_running_statistics_are_per_object():
    """The embedding of [c (128) || one-hot (81)] over 3 objects."""
    check_label_embed_statistics(128 + 81, 128, 3)


@pytest.mark.parametrize("train", [False, True], ids=["eval-mu", "train-eps"])
def test_ca_net_matches_jax_with_eps_injected(train):
    """fc + ReLU, mu and logvar, and c = mu + eps * exp(logvar / 2) with
    the eps JAX draws from its rng passed in (c = mu without one)."""
    rng = np.random.RandomState(19)
    text = rng.randn(5, 1024).astype(np.float32)
    jmod = JCANet(128)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(text), None)
    params = _randomize(jax.tree.map(np.asarray, variables["params"]), rng,
                        "params")
    key = jax.random.PRNGKey(20) if train else None
    c, mu, logvar = jmod.apply({"params": params}, jnp.asarray(text), key)
    port = CANet(1024, 128)
    fc = params["Dense_0"]["Dense_0"]
    port.fc.load_state_dict({"weight": torch.from_numpy(fc["kernel"].T.copy()),
                             "bias": torch.from_numpy(fc["bias"])})
    eps = None
    if train:
        eps = torch.from_numpy(np.array(jax.random.normal(
            key, (5, 128), jnp.float32)))
    got = port(torch.from_numpy(text), eps)
    for name, g, w in zip(("c", "mu", "logvar"), got, (c, mu, logvar)):
        _close(g, w, name)
    assert float(got[2].detach().abs().max()) > 0.5   # logvar matters in c
    if not train:
        assert got[0] is got[1]


def test_g_state_dict_routes_agree_and_load_strict(nets):
    """The JAX package's export_stage1_g and the port's mapping give the
    same keys and values, ``label.*`` and ``ca_net.fc.*`` included."""
    _, _, (p, s), _ = nets
    direct = stage1_g_state_dict_from_jax(p, s, PCFG)
    exported = {k: torch.as_tensor(np.array(v))
                for k, v in tx.export_stage1_g(p, s, JCFG).items()}
    assert sorted(direct) == sorted(exported)
    assert direct["label.0.weight"].shape == (128, 128 + 81)
    assert direct["ca_net.fc.weight"].shape == (256, 1024)
    for k in direct:
        np.testing.assert_array_equal(
            direct[k].numpy(), exported[k].numpy().reshape(direct[k].shape),
            err_msg=k)
    Stage1G(PCFG).load_state_dict(exported, strict=True)


def test_one_step_matches_jax_make_train_step():
    """The step with the mu condition detached in both losses and
    KL x 2 in the G loss; ``kl_loss`` is among the losses held."""
    data = synthetic_coco(B, seed=21)
    data["text_embedding"] = data["text_embedding"][:, 1].copy()
    got = check_one_step(JCFG, PCFG, data, (21, 51), kl_coeff=KL_COEFF)
    np.testing.assert_allclose(
        float(got["g_loss_total"]),
        float(got["g_loss"]) + KL_COEFF * float(got["kl_loss"]), rtol=1e-6)


def test_trained_fullwidth_checkpoint_matches_jax():
    """runs_r5/stackgan1_repin/netG_final.pth (ngf 1536, 25.92 M
    parameters), c = mu."""
    check_trained_checkpoint(CKPT, "coco-stackgan-1", "cfg/coco_s1_train.yml",
                             25_922_368, coco_batch(22, b=2))


def test_synthetic_coco_equals_the_jax_writers_draws(tmp_path):
    """Boxes, one-hots (pad -> 80) and caption embeddings equal the JAX
    writer's pickles; each image holds its last object's rectangle in the
    label's colour, as the writer's JPEG does."""
    data_dir, img_dir = str(tmp_path / "data"), str(tmp_path / "img")
    write_synthetic_coco(data_dir, img_dir, n=24, seed=5)
    split = os.path.join(data_dir, "train")

    def load(name):
        with open(os.path.join(split, name), "rb") as f:
            return pickle.load(f)

    names, bboxes = load("filenames.pickle"), load("bboxes.pickle")
    labels = load("labels.pickle")
    embs = load("char-CNN-RNN-embeddings.pickle")
    got = synthetic_coco(24, seed=5)
    assert got["image"].shape == (24, 64, 64, 3)
    np.testing.assert_array_equal(got["bbox"], bboxes)
    np.testing.assert_array_equal(got["text_embedding"], embs)
    for i in range(24):
        np.testing.assert_array_equal(got["label_onehot"][i],
                                      labels_to_onehot(labels[i]))
        last = int((bboxes[i, :, 0] >= 0).sum()) - 1
        x, y, w, h = bboxes[i, last]
        lab = int(labels[i, last, 0])
        color = [120 + 135 * ((lab * k) % 9) // 8 for k in (1, 2, 3)]
        # the rectangle's inside, 2 pixels from its edges at 64
        y0, y1 = int(y * 64) + 2, int((y + h) * 64) - 2
        x0, x1 = int(x * 64) + 2, int((x + w) * 64) - 2
        inside = got["image"][i, y0:y1, x0:x1].reshape(-1, 3)
        assert (inside == np.array(color, np.uint8)).all()
        jpeg = np.asarray(Image.open(os.path.join(img_dir,
                                                  names[i] + ".jpg")))
        grid = np.arange(64) * 96 // 64
        jpeg64 = jpeg[grid][:, grid][y0:y1, x0:x1].reshape(-1, 3)
        assert np.abs(jpeg64.mean(0) - np.array(color)).max() < 12


def test_config_reads_the_published_coco_s1_widths_and_kl():
    """cfg/coco_s1_train.yml, whose TRAIN.COEFF.KL sits three levels
    deep, as PyYAML reads it."""
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_s1_train.yml"),
                        "coco-stackgan-1")
    mcfg = stage1_model_config(cfg, "coco-stackgan-1")
    assert (mcfg.ngf, mcfg.df_dim, mcfg.condition_dim, mcfg.text_dim,
            mcfg.num_objects, mcfg.label_dim, mcfg.d_cond_dim) == (
        1536, 96, 128, 1024, 3, 81, 128)
    assert mcfg.use_ca and mcfg.use_label_embed
    train = train_settings(cfg)
    assert (train.batch_size, train.max_epoch, train.lr_decay_epoch,
            train.kl_coeff) == (128, 120, 20, 2.0)
    assert cfg.TRAIN.COEFF.KL == 2.0


@pytest.mark.parametrize("flags", [(), ("--bn_groups", "2")],
                         ids=["f32", "bn-groups-2"])
def test_cli_main_trains_one_synthetic_coco_epoch(tmp_path, capsys, flags):
    hist = check_cli_epoch(tmp_path, "coco-stackgan-1", 64 // 8, flags)
    assert np.isfinite(hist["kl_loss"]) and hist["kl_loss"] > 0
    out = capsys.readouterr().out
    assert "coco-stackgan-1 stage 1 on cpu: ngf 64, ndf 8, 3 objects" in out
    assert "KL x 2" in out and "kl_loss=" in out


def test_cli_entries_refuse_coco_without_a_card(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path, "coco-stackgan-1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--variant", "coco-stackgan-1", "--cfg", cfg,
                        "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.build_service(port_serve.parse_args(
            ["--variant", "coco-stackgan-1"]))


@pytest.fixture(scope="module")
def server():
    srv = Server("coco-stackgan-1", PCFG)
    yield srv
    srv.close()


def test_service_takes_text_embeddings(server):
    rs = np.random.RandomState(23)
    items = [{"labels": [5, 17], "bboxes": [[0.1, 0.1, 0.3, 0.3],
                                            [0.5, 0.5, 0.4, 0.3]],
              "text_embedding": rs.randn(1024).tolist()},
             {"text_embedding": rs.randn(1024).tolist()}]
    status, body = server.post(items)
    assert status == 200 and len(body["images"]) == 2, body


@pytest.mark.parametrize("item, message", [
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, 0.3]],
      "text_embedding": [0.0] * 1023}, "1024 values"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "text_embedding"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, 0.3]],
      "text_embedding": [float("nan")] * 1024}, "finite"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, -0.2]],
      "text_embedding": [0.0] * 1024}, "w, h > 0"),
    ({"labels": [81], "bboxes": [[0.1, 0.1, 0.3, 0.3]],
      "text_embedding": [0.0] * 1024}, "outside"),
], ids=["1023-values", "no-embedding", "nan-embedding", "F2-negative-height",
        "F3-id-81"])
def test_service_rejects_bad_coco_items(server, item, message):
    status, body = server.post([item])
    assert status == 400 and message in body["error"], body
