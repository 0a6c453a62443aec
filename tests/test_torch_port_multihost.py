"""The port's data-parallel layer (multiple_objects_gan_tpu_torch/parallel)
as two real processes: a process group over gloo on a free localhost port,
on the CPU, modelled on tests/test_multihost.py and its worker. The two
ranks start once for the file (``tools/dist_steps.py:spawn``) and run
every case of tests/torch_port_dist_cases.py in that one start.

* The mnist step at GF 16 / DF 8 on a global batch of 8 (4 a rank)
  equals JAX's single-process ``make_train_step`` on the same batch and
  injected z, at tests/test_step_parity.py's criteria (losses atol 1e-3,
  running statistics atol 5e-4, per-tensor Adam-delta cosine > 0.999,
  mean |difference| < 0.02 lr, at most 0.5 % of the elements apart by
  more than 0.5 lr): the wrong pair's row at the rank boundary comes from
  rank 1, and every BatchNorm takes the global batch's statistics (D's
  conditional head sees 4 rows on rank 0 and 3 on rank 1).
* The AttnGAN step (gf 8, df 8, embedding 16, R_NUM 1, three branches,
  batch 4, 2 a rank; class ids 3, 1, 3, 7, whose repeat crosses the
  boundary) and the DAMSM step (batch 8, the text encoder's clip at 0.25
  biting) equal the port's one-process step, which tests/test_torch_port_
  {attngan,damsm}_step.py hold against JAX, from one warm Adam state:
  losses atol 1e-5 + rtol 1e-5, the clip's norm rtol 1e-5, running
  statistics atol 1e-5, per-tensor update cosine > 0.99999 and the update
  within 1e-3 of its norm, the EMA atol 1e-7.
* After every step both ranks hold the same parameters, buffers and Adam
  states, bit for bit.
* The Loader's shards are disjoint, of equal length, and exactly
  ``order[rank::world]`` of the seeded order.
* AttnGAN's sampling dump at world 2 (batch 3 padded to 4, 5 of the 6
  test images) writes the same files as at world 1, their pixels within
  1 level of 255, and rank 0 gathers features within 1e-5 of world 1's.
* A world-2 AttnGAN run from disk, cut after epoch 1 and resumed, ends
  bit for bit where an uninterrupted world-2 run ends: every rank's
  reader state is checkpointed (WORDS_NUM 5, so that the two ranks'
  readers draw differently and each must get its own back).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_dist_cases as cases
from multiple_objects_gan_tpu.io.torch_import import (
    import_stage1_d, import_stage1_g)
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.data.datasets import Loader
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.attngan import COCO_ATTN
from multiple_objects_gan_tpu_torch.nn.encoders import RNNEncoder
from multiple_objects_gan_tpu_torch.tools import dist_steps
from multiple_objects_gan_tpu_torch.train.state import (
    create_attngan_state, create_damsm_state, create_state)
from test_step_parity import _layout_batch, _replay_step_noise
from test_torch_parity import _randomize
from test_torch_port_attngan_step import make_batch as attn_batch
from test_torch_port_damsm_step import _batch as damsm_batch
from test_torch_port_stage2_step import _warm_adam
from test_torch_port_step import _compare_deltas, _compare_stats

TESTS = os.path.dirname(os.path.abspath(__file__))
LR = 2e-4
MNIST_B = 8
JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=16, df_dim=8)
PCFG = dataclasses.replace(common.MNIST, gf_dim=16, df_dim=8)
ATTN_CFG = dataclasses.replace(COCO_ATTN, gf_dim=8, df_dim=8,
                               condition_dim=16, embedding_dim=16,
                               branch_num=3, r_num=1)
ATTN_SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 50.0}
DAMSM_B, DAMSM_T, DAMSM_WORDS = 8, 6, 20
DAMSM_SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0}
LOSS_ATOL = 1e-5
LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
MIN_UPDATE_COSINE = 0.99999
UPDATE_REL = 1e-3
EMA_ATOL = 1e-7
DUMP = {"batch": 3, "num_images": 5}
DUMP_LEVELS = 1
DUMP_FEATURE_ATOL = 1e-5
SEED = 3
ATTN_BATCH = 8            # the entry's global batch: 4 a rank
WORKER_ENV = {"OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the cases


def _mnist(warm: bool = False):
    """The mnist case: the port's state with tests/test_step_parity.py's
    weights, the JAX state holding them (both Adams warm with ``warm``:
    tests/test_torch_port_stage2_step.py:_warm_adam), the global batch and
    the JAX step's z."""
    state = create_state(PCFG, device="cpu")
    _randomize(state.g, seed=3)
    _randomize(state.d, seed=11)
    sd_g = {k: v.numpy().copy() for k, v in state.g.state_dict().items()}
    sd_d = {k: v.numpy().copy() for k, v in state.d.state_dict().items()}
    g_params, g_stats = import_stage1_g({"netG": sd_g}, JCFG)
    d_params, d_stats = import_stage1_d(sd_d, JCFG)
    jg, jd = JStage1G(JCFG), JStage1D(JCFG)
    jstate = jcreate_state(JCFG, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    jstate = jstate.replace(g_params=g_params, g_stats=g_stats,
                            d_params=d_params, d_stats=d_stats)
    if warm:
        jstate = _warm_adam(state, jstate)
    bbox, onehot, rs = _layout_batch(MNIST_B, 3, 10, seed=7)
    batch = {"image": rs.randint(0, 256, (MNIST_B, 64, 64, 1)).astype(
        np.uint8), "bbox": bbox, "label_onehot": onehot}
    rng = jax.random.PRNGKey(42)
    z, _ = _replay_step_noise(rng, 0, MNIST_B, JCFG.z_dim)
    new_jstate, metrics = jax.jit(jmake_train_step(JCFG, jg, jd))(
        jstate, jax.tree.map(jnp.asarray, batch), rng, jnp.float32(LR),
        jnp.float32(LR))
    case = {"name": "mnist", "kind": "stage1", "config": PCFG,
            "state": state, "seed": 0, "lr": LR, "z": torch.from_numpy(
                np.array(z)),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": stage1_g_state_dict_from_jax(new_jstate.g_params,
                                              new_jstate.g_stats, PCFG),
            "d": stage1_d_state_dict_from_jax(new_jstate.d_params,
                                              new_jstate.d_stats)}
    return case, want


def _attngan():
    state = create_attngan_state(ATTN_CFG, device="cpu")
    chip_smoke.he_randomize(state.g, 3)
    for i, d in enumerate(state.ds.values()):
        chip_smoke.he_randomize(d, 4 + i)
    state.g_ema.update({k: p.detach().clone()
                        for k, p in state.g.named_parameters()})
    chip_smoke.warm_adam(state)
    torch.manual_seed(5)
    text = RNNEncoder(20, ninput=8, nhidden=16).eval()
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in attn_batch(9).items()}
    return {"name": "attngan", "kind": "attngan", "config": ATTN_CFG,
            "state": state, "encoders": (text, cases.PoolImageEncoder(16)),
            "smooth": ATTN_SMOOTH, "batch": batch, "seed": 6, "lr": LR}


def _damsm():
    torch.manual_seed(7)
    text = RNNEncoder(DAMSM_WORDS, ninput=8, nhidden=16)
    state = create_damsm_state(text, cases.HeadImageEncoder(16).eval())
    chip_smoke.warm_opt(state.opt)
    raw = damsm_batch(b=DAMSM_B, t=DAMSM_T, seed=8, ntoken=DAMSM_WORDS)
    raw["class_ids"] = np.array([0, 1, 2, 5, 1, 4, 0, 6], np.int32)
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 else v) for k, v in raw.items()}
    return {"name": "damsm", "kind": "damsm", "state": state,
            "smooth": DAMSM_SMOOTH, "grad_clip": 0.25, "batch": batch,
            "seed": 9, "lr": 2e-3}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case at world 2 (one spawn) and the one-process references."""
    tmp = tmp_path_factory.mktemp("multihost")
    mnist, want = _mnist()
    data, imgs = str(tmp / "dump_data"), str(tmp / "dump_imgs")
    write_synthetic_attngan(data, imgs, n=24, seed=SEED)
    n_words = AttnGanDataset(data, "test").n_words
    dump = dict(data=data, imgs=imgs, n_words=n_words, **DUMP)
    cfg = cases.tiny_attngan_cfg(str(tmp / "attn.yml"), str(tmp / "data"),
                                 ATTN_BATCH)

    def entry(out, *flags):
        return ["--variant", "coco-attngan", "--cfg", cfg, "--synthetic",
                "--manualSeed", str(SEED), "--device", "cpu",
                "--img_dir", str(tmp / "imgs"), "--output_dir",
                str(tmp / out), *flags]

    call = "torch_port_dist_cases:"
    steps = [mnist, _attngan(), _damsm()]
    world2 = steps + [
        {"name": "dump", "call": call + "sampling_dump",
         "kwargs": dict(dump, out=str(tmp / "dump2"))},
        {"name": "straight", "call": call + "attngan_entry",
         "kwargs": {"argv": entry("straight", "--max_epochs", "2")}},
        {"name": "cut", "call": call + "attngan_entry",
         "kwargs": {"argv": entry("cut", "--max_epochs", "1")}},
        {"name": "resumed", "call": call + "attngan_entry",
         "kwargs": {"argv": entry("cut", "--max_epochs", "2", "--resume",
                                  str(tmp / "cut"))}}]
    path = str(tmp / "cases.pth")
    torch.save(world2, path)
    ranks = dist_steps.spawn(path, str(tmp / "out"), world=2, device="cpu",
                             timeout=480, extra_path=(TESTS,),
                             env={**os.environ, **WORKER_ENV})
    one = dist_steps.run_cases(copy.deepcopy(steps[1:]), "cpu")
    one["dump"] = cases.sampling_dump(out=str(tmp / "dump1"), **dump)
    return {"tmp": tmp, "ranks": ranks, "one": one, "jax": want,
            "pre": {c["name"]: _pre(c["state"]) for c in steps}}


def _pre(state) -> dict:
    return copy.deepcopy(state.checkpoint_dict())


def _result(run, rank, name):
    """A step case's record, or a call case's return value."""
    got = run["ranks"][rank]["results"][name]
    return got["value"] if "value" in got else got


# ------------------------------------------------------------ the checks


def _same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _modules(ckpt: dict) -> dict:
    """{name: state dict} of a checkpoint's modules."""
    out = {}
    for k in ("g", "d", "text", "image"):
        if k in ckpt:
            out[k] = ckpt[k]
    if isinstance(ckpt.get("d"), dict) and "g_ema" in ckpt:
        out.pop("d")
        out.update({f"d.{n}": sd for n, sd in ckpt["d"].items()})
    return out


def _updates_close(pre: dict, got: dict, want: dict, what: str):
    """Per parameter: the update of ``got`` against ``want``'s, cosine >
    MIN_UPDATE_COSINE and within UPDATE_REL of its norm; running
    statistics atol STATS_ATOL."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), f"{what}:{k}"
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=STATS_ATOL, err_msg=f"{what}:{k}")
            continue
        dg = (got[k] - pre[k]).double().flatten()
        dw = (w - pre[k]).double().flatten()
        if float(dw.norm()) == 0.0:
            assert float(dg.norm()) == 0.0, f"{what}:{k}"
            continue
        cos = float(dg @ dw / (dg.norm() * dw.norm()))
        assert cos > MIN_UPDATE_COSINE, f"{what}:{k} update cosine {cos}"
        assert float((dg - dw).norm()) <= UPDATE_REL * float(dw.norm()), (
            f"{what}:{k}")


def _losses_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=LOSS_ATOL,
                                   rtol=LOSS_RTOL, err_msg=k)


def test_two_process_mnist_step_matches_jax_single_process(run):
    """Both ranks against JAX's one-process step on the global batch of 8,
    the replicas equal bit for bit."""
    want = run["jax"]
    pre = run["pre"]["mnist"]
    for r in (0, 1):
        got = _result(run, r, "mnist")
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-3,
                                       err_msg=f"rank {r} loss {k}")
        post = got["state"]
        _compare_stats(post["g"], want["g"], f"rank {r} g_stats")
        _compare_stats(post["d"], want["d"], f"rank {r} d_stats")
        _compare_deltas(pre["g"], post["g"], want["g"], f"rank {r} G")
        _compare_deltas(pre["d"], post["d"], want["d"], f"rank {r} D")
    _same_bits(_result(run, 0, "mnist")["state"],
               _result(run, 1, "mnist")["state"])


@pytest.mark.parametrize("name", ["attngan", "damsm"])
def test_two_process_step_matches_one_process(run, name):
    """The AttnGAN and DAMSM steps at world 2 against the port's one
    process on the same global batch: the losses (the DAMSM word and
    sentence terms over the global 4 x 4 or 8 x 8 scores, the clip's norm
    of the summed gradient), statistics, updates and the EMA; the replicas
    equal bit for bit."""
    want = run["one"][name]
    pre = _modules(run["pre"][name])
    for r in (0, 1):
        got = _result(run, r, name)
        _losses_close(got["metrics"], want["metrics"])
        wmods, gmods = _modules(want["state"]), _modules(got["state"])
        for part, sd in wmods.items():
            _updates_close(pre[part], gmods[part], sd, f"rank {r} {part}")
        if "g_ema" in want["state"]:
            for k, v in want["state"]["g_ema"].items():
                np.testing.assert_allclose(
                    got["state"]["g_ema"][k].numpy(), v.numpy(),
                    atol=EMA_ATOL, err_msg=f"rank {r} ema {k}")
    _same_bits(_result(run, 0, name)["state"],
               _result(run, 1, name)["state"])
    if name == "damsm":
        assert want["metrics"]["rnn_grad_norm"] > 0.25    # the clip bites


def test_loader_shards_are_order_rank_strided():
    """Two epochs of 10 items at batch 2 over world 2: each rank's rows are
    ``order[rank::2]`` of the seeded order (two batches, one row of each
    shard left out), disjoint and of equal length, and ``len`` is
    ``10 // 2 // 2``."""
    class Rows:
        def __len__(self):
            return 10

        def get_batch(self, idxs):
            return {"i": np.asarray(idxs)}

    for epoch in (0, 1):
        order = np.arange(10)
        np.random.RandomState(3 + epoch).shuffle(order)
        flat = []
        for r in (0, 1):
            loader = Loader(Rows(), 2, seed=3, shard=(r, 2))
            assert len(loader) == 2
            rows = [int(i) for b in loader.epoch(epoch) for i in b["i"]]
            assert rows == order[r::2][:4].tolist()
            flat.append(rows)
        assert len(flat[0]) == len(flat[1]) == 4
        assert not set(flat[0]) & set(flat[1])


def test_sharded_dump_equals_one_process(run):
    """The dump at world 2 against world 1: the same PNG names, pixels
    within DUMP_LEVELS, features within DUMP_FEATURE_ATOL, the metrics
    from rank 0 alone."""
    one, two = run["one"]["dump"], _result(run, 0, "dump")
    assert _result(run, 1, "dump")["metrics"] is None
    d1, d2 = run["tmp"] / "dump1" / "single_samples", \
        run["tmp"] / "dump2" / "single_samples"
    names = sorted(os.listdir(d1))
    assert names == [f"s_{i:06d}.png" for i in range(DUMP["num_images"])]
    assert sorted(os.listdir(d2)) == names
    for n in names:
        a = read_png(str(d1 / n), "RGB").astype(int)
        b = read_png(str(d2 / n), "RGB").astype(int)
        assert np.abs(a - b).max() <= DUMP_LEVELS, n
    for k in ("real_acts", "fake_acts"):
        assert two[k].shape == (DUMP["num_images"], cases.FEATURES)
        np.testing.assert_allclose(two[k], one[k], atol=DUMP_FEATURE_ATOL,
                                   err_msg=k)
    assert two["metrics"]["n_images"] == DUMP["num_images"]
    for k in ("fid", "inception_score_mean", "inception_score_std"):
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k],
                                   rtol=1e-4, atol=1e-8, err_msg=k)


def test_world2_attngan_resume_equals_an_uninterrupted_run(run):
    """The world-2 entry from disk, 4 steps an epoch (32 items, 8 a global
    batch): cut after epoch 1 and resumed to 2, against 2 straight epochs,
    the final checkpoints equal bit for bit, each rank's reader state
    among them."""
    for r in (0, 1):
        hist = _result(run, r, "straight")
        assert [h["steps"] for h in hist] == [4, 4]
        assert [h["steps"] for h in _result(run, r, "resumed")] == [4]
    got, _ = CheckpointManager(str(run["tmp"] / "cut" / "models")).load(1)
    ref, _ = CheckpointManager(
        str(run["tmp"] / "straight" / "models")).load(1)
    assert got["step"] == ref["step"] == 8
    states = ref["extra"]["data_rng_ranks"]
    assert len(states) == 2
    assert not torch.equal(states[0]["keys"], states[1]["keys"]) or (
        states[0]["pos"] != states[1]["pos"]), "the ranks drew alike"
    _same_bits(got, ref)
    assert not os.path.exists(run["tmp"] / "straight" / "images" /
                              "fake_samples_epoch_000.png")
