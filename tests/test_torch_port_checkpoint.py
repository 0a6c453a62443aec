"""The port's checkpoints, resume, warm start and run records
(multiple_objects_gan_tpu_torch: ``io/checkpoint.py``, ``train/loop.py:
train``, ``io/weights.py:load_reference_d``/``warm_start``, ``cli/main.py``)
on the CPU, at GF/DF 8.

* A checkpoint round trip gives back every tensor, both Adam states, the
  step, the epoch and the train step's generator, bit for bit.
* Resume is held bit for bit on the CPU: Multi-MNIST 2 epochs straight
  against 1 epoch and a resumed 1 (losses, parameters, BatchNorm buffers,
  Adam states). The set is Multi-MNIST because, as in the JAX package,
  the readers' own random streams (CLEVR's h-flip ``RandomState``, COCO's
  caption draw) start again from the seed in a resumed process and are not
  checkpointed, so a resumed CLEVR or COCO run flips and draws other items
  than an uninterrupted one.
* The learning-rate halving of a resumed run equals a fresh run's
  (tests/test_loop_schedule.py), the last epoch is always checkpointed,
  and ``run_flags.json`` behaves as the JAX CLI's (tests/test_resume.py).
* A D ``.pth`` written by the JAX package's ``io/torch_export.py`` loads
  strict=True and gives the JAX-imported D's logits within 1e-5.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.cli import main as jmain
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.io import torch_import as ti
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.train.step import create_state as jcreate_state
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import default_config
from multiple_objects_gan_tpu_torch.data.datasets import (
    Loader, MemoryLoader, MultiMnistDataset, write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_multimnist
from multiple_objects_gan_tpu_torch.io import checkpoint as ckpt_mod
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_d, warm_start)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_d
from multiple_objects_gan_tpu_torch.train.loop import run_epochs, train
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import (
    make_sample_fn, make_train_step)
from test_torch_port_stage1g import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
PCFG = dataclasses.replace(common.MNIST, gf_dim=8, df_dim=8)
JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=8, df_dim=8)
LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stepped_state(seed=0):
    """A state after one step (so both Adams hold moments) and the step's
    generator."""
    state = create_state(PCFG, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_multimnist(8, seed=seed).items()}
    make_train_step(PCFG)(state, batch, gen, 2e-4, 2e-4)
    return state, gen


def _tensors(state):
    out = {f"g.{k}": v for k, v in state.g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.d.state_dict().items()})
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name).state_dict()["state"]
        for i, s in opt.items():
            for k, v in s.items():
                out[f"{name}.{i}.{k}"] = v
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


# ----------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_gives_back_every_tensor(tmp_path):
    state, gen = _stepped_state(0)
    mgr = CheckpointManager(str(tmp_path / "models"))
    mgr.save(3, state, gen)
    back, gen2 = _stepped_state(1)
    assert mgr.restore(back, gen2)[0] == 3
    _assert_states_equal(state, back)
    assert any(k.endswith("exp_avg_sq") for k in _tensors(back))
    assert any("running_var" in k for k in _tensors(back))
    assert torch.equal(torch.randn(5, generator=gen),
                       torch.randn(5, generator=gen2))
    assert back.g_opt.param_groups[0]["betas"] == (0.5, 0.999)


def test_checkpoints_keep_the_newest_five(tmp_path):
    state, gen = _stepped_state(0)
    assert ckpt_mod.MAX_TO_KEEP == 5
    mgr = CheckpointManager(str(tmp_path))
    for epoch in range(8):
        state.step = epoch
        mgr.save(epoch, state, gen)
    assert mgr.epochs() == [3, 4, 5, 6, 7]
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "6", "7"]
    assert mgr.latest_epoch() == 7
    assert mgr.load(4)[0]["step"] == 4


def test_a_save_cut_before_its_rename_leaves_the_latest_intact(
        tmp_path, monkeypatch):
    state, gen = _stepped_state(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, gen)
    saved = {k: v.clone() for k, v in _tensors(state).items()}
    make_train_step(PCFG)(state, {k: torch.from_numpy(v) for k, v in
                                  synthetic_multimnist(8, seed=5).items()},
                          gen, 2e-4, 2e-4)

    def cut(src, dst):
        raise OSError("power cut")

    monkeypatch.setattr(ckpt_mod.os, "replace", cut)
    with pytest.raises(OSError, match="power cut"):
        mgr.save(2, state, gen)
    monkeypatch.undo()
    assert os.path.isfile(tmp_path / "2" / "state.pth.tmp")
    assert mgr.latest_epoch() == 1
    back, gen2 = _stepped_state(1)
    assert mgr.restore(back, gen2)[0] == 1
    for k, v in _tensors(back).items():
        assert torch.equal(v, saved[k]), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(back)


# ---------------------------------------------------------------- resume


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist"))
    write_synthetic_multimnist(d, n=16, seed=0)
    write_synthetic_multimnist(d, n=16, split="test", seed=1)
    return d


def _cfg(snapshot=1, decay=1):
    cfg = default_config("multi-mnist")
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TRAIN.SNAPSHOT_INTERVAL = snapshot
    cfg.TRAIN.LR_DECAY_EPOCH = decay
    return cfg


def _train(cfg, data_dir, out, **kw):
    loader = Loader(MultiMnistDataset(data_dir), 8, seed=0)
    return train(cfg, PCFG, loader, out, device="cpu", seed=0, **kw)


def test_resume_equals_an_uninterrupted_run_bit_for_bit(mnist_dir, tmp_path,
                                                        capsys):
    """2 epochs straight against 1 + a resumed 1, with the learning rate
    halved at epoch 1: the second epoch's losses, every parameter,
    BatchNorm buffer and Adam moment, and the step count are equal."""
    cfg = _cfg()
    straight, hist = _train(cfg, mnist_dir, str(tmp_path / "a"),
                            max_epochs=2)
    _train(cfg, mnist_dir, str(tmp_path / "b"), max_epochs=1)
    resumed, hist_r = _train(cfg, mnist_dir, str(tmp_path / "b2"),
                             max_epochs=2, resume_dir=str(tmp_path / "b"))
    assert "at epoch 1" in capsys.readouterr().out
    assert len(hist) == 2 and len(hist_r) == 1
    assert hist_r[0].keys() == hist[1].keys()
    for k in hist[1]:
        if k != "seconds":
            assert hist_r[0][k] == hist[1][k], k
    _assert_states_equal(straight, resumed)
    assert resumed.step == 4


def test_resume_without_the_generator_state_draws_other_noise(
        mnist_dir, tmp_path, monkeypatch):
    """The generator's state is what makes the resumed noise equal: a
    restore that skips it gives another second epoch."""
    cfg = _cfg()
    straight, _ = _train(cfg, mnist_dir, str(tmp_path / "a"), max_epochs=2)
    _train(cfg, mnist_dir, str(tmp_path / "b"), max_epochs=1)
    restore = CheckpointManager.restore
    monkeypatch.setattr(
        CheckpointManager, "restore",
        lambda self, state, generator=None, epoch=None: restore(
            self, state, None, epoch))
    resumed, _ = _train(cfg, mnist_dir, str(tmp_path / "b2"), max_epochs=2,
                        resume_dir=str(tmp_path / "b"))
    assert not torch.equal(straight.g.fc[0].weight, resumed.g.fc[0].weight)


def _lrs(start_epoch, n_epochs, decay):
    lrs = []

    def step_fn(state, batch, generator, lr_g, lr_d):
        lrs.append(lr_g)
        return {"loss": torch.tensor(0.0)}

    data = {"image": np.zeros((2, 1, 1, 1), np.uint8)}
    run_epochs(types.SimpleNamespace(g=torch.nn.Linear(1, 1), step=0),
               MemoryLoader(data, 2), step_fn, None, lr_g=1.0, lr_d=1.0,
               n_epochs=n_epochs, start_epoch=start_epoch,
               lr_decay_epochs=decay)
    return lrs


def test_lr_halving_on_resume_equals_a_fresh_runs():
    assert _lrs(0, 4, 2) == [1.0, 1.0, 0.5, 0.5]
    assert _lrs(2, 4, 1) == [0.25, 0.125] == _lrs(0, 4, 1)[2:]


def test_the_last_epoch_is_always_checkpointed(mnist_dir, tmp_path):
    out = str(tmp_path / "run")
    _train(_cfg(snapshot=50), mnist_dir, out, max_epochs=2)
    assert CheckpointManager(os.path.join(out, "models")).epochs() == [1]


def test_the_step_after_a_grid_updates_batchnorm_statistics():
    """The epoch grid leaves G in eval mode; the next step puts it back in
    train mode, so its BatchNorm running statistics move."""
    state, gen = _stepped_state(0)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_multimnist(8, seed=2).items()}
    make_sample_fn(PCFG)(state.g, torch.randn(8, PCFG.z_dim), batch["bbox"],
                         batch["label_onehot"])
    assert not state.g.training
    before = state.g.fc[1].running_mean.clone()
    make_train_step(PCFG)(state, batch, gen, 2e-4, 2e-4)
    assert state.g.training
    assert not torch.equal(before, state.g.fc[1].running_mean)


# ------------------------------------------------------------ run flags


def test_resume_flag_mismatch_warns_as_the_jax_cli(tmp_path):
    prev = tmp_path / "prev"
    prev.mkdir()
    (prev / "run_flags.json").write_text(json.dumps(
        {"bn_groups": 2, "bf16": True, "variant": "multi-mnist",
         "manualSeed": 7}))
    for module in (port_main, jmain):
        with pytest.warns(UserWarning, match="bn_groups differs"):
            assert module.check_resume_flags(str(prev), bn_groups=1,
                                             bf16=True) == ["bn_groups"]
        with pytest.warns(UserWarning, match="bf16 differs"):
            module.check_resume_flags(str(prev), bn_groups=2, bf16=False)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert module.check_resume_flags(str(prev), bn_groups=2,
                                             bf16=True) == []
            assert module.check_resume_flags(str(tmp_path), bn_groups=1,
                                             bf16=False) == []


def test_record_run_flags_keeps_the_original_on_an_in_place_resume(
        tmp_path):
    out = tmp_path / "run"
    out.mkdir()
    path = port_main.record_run_flags(str(out), None, bn_groups=2,
                                      bf16=True, variant="multi-mnist",
                                      manualSeed=7)
    with pytest.warns(UserWarning, match="differs"):
        port_main.record_run_flags(str(out), str(out), bn_groups=1,
                                   bf16=False, variant="multi-mnist",
                                   manualSeed=7)
    assert json.loads(open(path).read())["bn_groups"] == 2
    out2 = tmp_path / "run2"
    out2.mkdir()
    with pytest.warns(UserWarning, match="bf16 differs"):
        p2 = port_main.record_run_flags(str(out2), str(out), bn_groups=2,
                                        bf16=False, variant="multi-mnist",
                                        manualSeed=7)
    assert json.loads(open(p2).read())["bf16"] is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_main.record_run_flags(str(out), str(out), bn_groups=2,
                                   bf16=True, variant="multi-mnist",
                                   manualSeed=7)


def test_record_run_flags_records_the_git_sha(tmp_path):
    path = port_main.record_run_flags(str(tmp_path), None, bn_groups=1,
                                      bf16=False, variant="multi-mnist",
                                      manualSeed=7)
    flags = json.loads(open(path).read())
    sha = port_main._git_sha()
    assert sha == jmain._git_sha()
    if sha:
        assert flags["git_sha"] == sha
        assert re.fullmatch(r"[0-9a-f]{40}(-dirty)?", sha)
    else:
        assert "git_sha" not in flags


# ---------------------------------------------------------- the CLI path


def _tiny_cfg(tmp_path, name, flag=True, net_g=""):
    text = open(os.path.join(ROOT, "cfg", name)).read()
    text = text.replace("DF_DIM: 64", "DF_DIM: 8").replace("GF_DIM: 128",
                                                           "GF_DIM: 8")
    if not flag:
        text = re.sub(r"NET_G: .*", f"NET_G: '{net_g}'", text)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_cli_trains_from_disk_resumes_and_samples(tmp_path, capsys):
    """The train entry writes the synthetic set to --data_dir and trains
    from it, leaving the run's records; --resume continues at the next
    epoch; TRAIN.FLAG False with NET_G the run's directory samples 25
    grids from its latest checkpoint."""
    data, out = str(tmp_path / "D"), str(tmp_path / "O")
    cfg = _tiny_cfg(tmp_path, "mnist_train.yml")
    args = ["--variant", "multi-mnist", "--cfg", cfg, "--data_dir", data,
            "--output_dir", out, "--synthetic", "--device", "cpu",
            "--manualSeed", "3"]
    hist = port_main.main([*args, "--max_epochs", "2"])
    assert [h["steps"] for h in hist] == [4, 4]
    assert len(os.listdir(os.path.join(data, "train", "normal", "imgs"))) \
        == 512
    for rel in ("logs/metrics.jsonl", "images/real_samples.png",
                "images/fake_samples_epoch_000.png",
                "images/fake_samples_epoch_001.png", "models/1/state.pth",
                "run_flags.json", "mnist_train.yml",
                "src_snapshot/csrc/stn_place.cu",
                "src_snapshot/train/loop.py"):
        assert os.path.isfile(os.path.join(out, rel)), rel
    assert sorted(os.listdir(os.path.join(out, "models"))) == ["1"]
    assert read_png(os.path.join(out, "images",
                                 "fake_samples_epoch_001.png"), "RGB"
                    ).shape == (530, 530, 3)
    flags = json.loads(open(os.path.join(out, "run_flags.json")).read())
    assert (flags["variant"], flags["manualSeed"], flags["bf16"]) == (
        "multi-mnist", 3, False)

    hist = port_main.main([*args, "--max_epochs", "3", "--resume", out])
    assert len(hist) == 1
    assert f"resumed from {out} at epoch 2" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(out, "models", "2", "state.pth"))
    assert os.path.isfile(os.path.join(out, "images",
                                       "fake_samples_epoch_002.png"))
    steps = [json.loads(line)["step"]
             for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
    assert steps == [0, 4, 8]

    write_synthetic_multimnist(data, n=16, split="test", seed=4)
    sample_cfg = _tiny_cfg(tmp_path, "mnist_eval.yml", flag=False,
                           net_g=out)
    assert port_main.main(["--variant", "multi-mnist", "--cfg", sample_cfg,
                           "--data_dir", data, "--output_dir",
                           str(tmp_path / "S"), "--device", "cpu"]) == []
    assert f"restored G from {out} (epoch 2)" in capsys.readouterr().out
    grids = sorted(os.listdir(tmp_path / "S" / "samples"))
    assert grids == [f"sample_{s:03d}.png" for s in range(25)]
    assert read_png(str(tmp_path / "S" / "samples" / grids[0]),
                    "RGB").shape == (134, 662, 3)


def test_cli_resume_without_a_seed_takes_the_runs_and_equals_a_straight_run(
        tmp_path, capsys):
    """A resume that omits --manualSeed takes the seed of the resumed run's
    run_flags.json: its shuffles, noise and grid equal a straight run's
    bit for bit on the CPU, and the in-place record keeps the seed."""
    data = str(tmp_path / "D")
    write_synthetic_multimnist(data, n=32, seed=2)
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(open(_tiny_cfg(tmp_path, "mnist_train.yml")).read()
                   .replace("BATCH_SIZE: 128", "BATCH_SIZE: 16"))

    def run(out, epochs, *extra):
        return port_main.main(["--variant", "multi-mnist", "--cfg", str(cfg),
                               "--data_dir", data, "--output_dir", out,
                               "--device", "cpu", "--max_epochs",
                               str(epochs), *extra])

    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    hist = run(straight, 2, "--manualSeed", "5")
    run(cut, 1, "--manualSeed", "5")
    capsys.readouterr()
    hist_r = run(cut, 2, "--resume", cut)
    assert f"seed 5 from {cut}/run_flags.json" in capsys.readouterr().out
    assert [h["steps"] for h in hist] == [2, 2] and len(hist_r) == 1
    for k in hist[1]:
        if k != "seconds":
            assert hist_r[0][k] == hist[1][k], k
    a = CheckpointManager(os.path.join(straight, "models")).load(1)[0]
    b = CheckpointManager(os.path.join(cut, "models")).load(1)[0]
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    for net in ("g", "d"):
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), f"{net}.{k}"
    grid = os.path.join("images", "fake_samples_epoch_001.png")
    assert np.array_equal(read_png(os.path.join(straight, grid), "RGB"),
                          read_png(os.path.join(cut, grid), "RGB"))
    flags = json.loads(open(os.path.join(cut, "run_flags.json")).read())
    assert flags["manualSeed"] == 5


def test_cli_resume_with_another_seed_warns(tmp_path):
    prev = tmp_path / "prev"
    prev.mkdir()
    (prev / "run_flags.json").write_text(json.dumps({"manualSeed": 5}))
    assert port_main.resumed_seed(str(prev)) == 5
    assert port_main.resumed_seed(str(tmp_path)) is None
    with pytest.warns(UserWarning, match="manualSeed differs"):
        port_main.record_run_flags(str(tmp_path), str(prev), bn_groups=1,
                                   bf16=False, variant="multi-mnist",
                                   manualSeed=6)


# ------------------------------------------------------------ warm start


@pytest.fixture(scope="module")
def jax_d():
    """A JAX Stage1D at width 8, every weight and statistic randomized."""
    st = jcreate_state(JCFG, JStage1G(JCFG), JStage1D(JCFG),
                       jax.random.PRNGKey(0), batch_size=2)
    rng = np.random.RandomState(7)
    return st, (_randomize(jax.tree.map(np.asarray, st.d_params), rng,
                           "params"),
                _randomize(jax.tree.map(np.asarray, st.d_stats), rng,
                           "stats"))


def test_jax_exported_d_pth_loads_strict_and_gives_the_jax_logits(
        jax_d, tmp_path):
    st, (p, s) = jax_d
    path = str(tmp_path / "netD.pth")
    tx.save_bare_state_dict(tx.export_stage1_d(p, s), path)
    port = build_stage1_d(PCFG, load_reference_d(path), device="cpu")
    jstate = ti.maybe_load_reference_d(path, JCFG, st)
    rs = np.random.RandomState(8)
    image = rs.uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32)
    data = synthetic_multimnist(4, seed=9)
    cond = data["label_onehot"].sum(1)
    jd = JStage1D(JCFG)
    jvars = {"params": jstate.d_params, "batch_stats": jstate.d_stats}
    feat = jd.apply(jvars, jnp.asarray(image),
                    jnp.asarray(data["label_onehot"]),
                    jnp.asarray(data["bbox"]), train=False)
    want = jd.apply(jvars, feat, jnp.asarray(cond), train=False,
                    method="cond_logits")
    with torch.no_grad():
        got = port.cond_logits(
            port(torch.from_numpy(np.transpose(image, (0, 3, 1, 2)).copy()),
                 torch.from_numpy(data["label_onehot"]),
                 torch.from_numpy(data["bbox"])), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


def test_warm_start_loads_net_g_and_net_d_pth_files(jax_d, tmp_path):
    _, (p, s) = jax_d
    d_path = str(tmp_path / "netD.pth")
    tx.save_bare_state_dict(tx.export_stage1_d(p, s), d_path)
    donor = create_state(PCFG, seed=5, device="cpu")
    g_path = str(tmp_path / "netG.pth")
    torch.save({"epoch": 3, "netG": donor.g.state_dict()}, g_path)
    state = create_state(PCFG, seed=0, device="cpu")
    assert warm_start(state, g_path, d_path) == [g_path, d_path]
    for k, v in donor.g.state_dict().items():
        assert torch.equal(state.g.state_dict()[k], v), k
    for k, v in load_reference_d(d_path).items():
        got = state.d.state_dict()[k]
        assert torch.equal(got, v.reshape(got.shape)), k
    assert warm_start(state, str(tmp_path / "missing.pth"), "") == []
    wide = create_state(dataclasses.replace(PCFG, df_dim=16), device="cpu")
    with pytest.raises(RuntimeError):
        warm_start(wide, "", d_path)
