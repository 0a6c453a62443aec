"""The port's checkpoint exporter (``multiple_objects_gan_tpu_torch/tools/
export_checkpoint.py``) against the JAX package's
``tools/export_checkpoint.py`` on the CPU, at small widths.

Each family's state is drawn in JAX (parameters, BatchNorm statistics and,
for AttnGAN, an EMA that differs from G), saved as the JAX package's orbax
checkpoint and exported by the JAX tool; the same weights, carried into a
port state (``io/weights.py:*_state_dict_from_jax``), are saved by the
port's ``CheckpointManager`` and exported by the port's tool. The two
``.pth`` files must hold the same container (keys, epoch, empty
optimizers), the same state-dict keys (the order is each model's
module order), and every tensor bit for bit, of the same dtype and
contiguous. ``num_batches_tracked`` is the one exception in shape: the
port writes torch's 0-d buffer, the JAX exporter a 1-d one
(``np.ascontiguousarray`` of a 0-d array); both read 0, and torch loads
either. Cases: stage 1 (Multi-MNIST, with
``--out_d``), stage 2 (with and without ``--s1_net_g``; the first with
``--out_d``) and AttnGAN (EMA, ``--raw``, ``--bare``, ``--out_d``).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.config import config as jconfig
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.io.checkpoint import (
    CheckpointManager as JCheckpointManager)
from multiple_objects_gan_tpu.models.stage1 import Stage1D, Stage1G
from multiple_objects_gan_tpu.models.stage2 import COCO_S2, Stage2D, Stage2G
from multiple_objects_gan_tpu.train.attngan_step import (
    create_attngan_state as jcreate_attngan_state)
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, create_state_stage2 as jcreate_stage2)
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file, stage1_model_config,
    stage2_model_config)
from multiple_objects_gan_tpu_torch.io import weights as w
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.pycompat import torch_load
from multiple_objects_gan_tpu_torch.models.attngan import D_NAMES
from multiple_objects_gan_tpu_torch.tools import export_checkpoint as port_tool
from multiple_objects_gan_tpu_torch.train.state import (
    create_attngan_state, create_state, create_state_stage2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import export_checkpoint as jax_tool  # noqa: E402

EPOCH = 3
CONTAINER = ["epoch", "netG", "optimG", "netD", "optimD"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jitter(tree, seed):
    """Every leaf moved by seeded noise, so that statistics and the EMA
    are not their init values."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + rs.uniform(0.1, 0.5, np.shape(x)).astype(
            np.asarray(x).dtype), tree)


def _yml(tmp, src, name, *pairs):
    with open(os.path.join(ROOT, "cfg", src)) as f:
        text = f.read()
    for a, b in pairs:
        assert a in text, a
        text = text.replace(a, b)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _save_jax(state, run):
    mgr = JCheckpointManager(os.path.join(run, "models"))
    mgr.save(EPOCH, state, wait=True)
    mgr.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the cfg, the JAX run dir and the port run dir of the
    same weights, and stage 2's stage-1 .pth."""
    tmp = str(tmp_path_factory.mktemp("export"))
    out = {}

    # stage 1, Multi-MNIST at GF 8 / DF 8
    cfg1 = _yml(tmp, "mnist_eval.yml", "mnist.yml",
                ("DF_DIM: 64", "DF_DIM: 8"), ("GF_DIM: 128", "GF_DIM: 8"))
    jm = jconfig.stage1_model_config(
        jconfig.cfg_from_file(cfg1, "multi-mnist"), "multi-mnist")
    st = jcreate_state(jm, Stage1G(jm), Stage1D(jm), jax.random.PRNGKey(4),
                       batch_size=2)
    st = st.replace(g_params=_jitter(st.g_params, 1),
                    g_stats=_jitter(st.g_stats, 2),
                    d_params=_jitter(st.d_params, 3),
                    d_stats=_jitter(st.d_stats, 4))
    _save_jax(st, os.path.join(tmp, "j1"))
    pm = stage1_model_config(cfg_from_file(cfg1, "multi-mnist"),
                             "multi-mnist")
    ps = create_state(
        pm, device="cpu",
        g_state_dict=w.stage1_g_state_dict_from_jax(st.g_params, st.g_stats,
                                                    pm),
        d_state_dict=w.stage1_d_state_dict_from_jax(st.d_params, st.d_stats))
    CheckpointManager(os.path.join(tmp, "p1", "models")).save(EPOCH, ps)
    out["stage1"] = (cfg1, os.path.join(tmp, "j1"), os.path.join(tmp, "p1"))

    # stage 2 at GF 8 / DF 4, condition 16, R_NUM 1
    cfg2 = _yml(tmp, "coco_s2_train.yml", "s2.yml",
                ("CONDITION_DIM: 128", "CONDITION_DIM: 16"),
                ("DF_DIM: 96", "DF_DIM: 4"), ("GF_DIM: 192", "GF_DIM: 8"),
                ("R_NUM: 2", "R_NUM: 1"))
    jcfg = jconfig.cfg_from_file(cfg2, "coco-stackgan")
    js1 = jconfig.stage1_model_config(jcfg, "coco-stackgan")
    js2 = dataclasses.replace(COCO_S2, gf_dim=8, df_dim=4, condition_dim=16,
                              d_cond_dim=16)
    s1 = jcreate_state(js1, Stage1G(js1), Stage1D(js1),
                       jax.random.PRNGKey(5), batch_size=2)
    s1_pth = os.path.join(tmp, "s1.pth")
    tx.save_reference_checkpoint(s1_pth, 0, net_g=tx.export_stage1_g(
        _jitter(s1.g_params, 5), _jitter(s1.g_stats, 6), js1))
    st2 = jcreate_stage2(js2, Stage2G(js2, r_num=1), Stage2D(js2),
                         jax.random.PRNGKey(6), batch_size=2)
    st2 = st2.replace(g_params=_jitter(st2.g_params, 7),
                      g_stats=_jitter(st2.g_stats, 8),
                      d_params=_jitter(st2.d_params, 9),
                      d_stats=_jitter(st2.d_stats, 10))
    _save_jax(st2, os.path.join(tmp, "j2"))
    _, p2 = stage2_model_config(cfg_from_file(cfg2, "coco-stackgan-2"))
    ps2 = create_state_stage2(p2, device="cpu")
    ps2.g.load_state_dict(w.stage2_g_state_dict_from_jax(
        st2.g_params, st2.g_stats, r_num=1))
    ps2.d.load_state_dict(w.stage2_d_state_dict_from_jax(st2.d_params,
                                                         st2.d_stats))
    CheckpointManager(os.path.join(tmp, "p2", "models")).save(EPOCH, ps2)
    out["stage2"] = (cfg2, os.path.join(tmp, "j2"), os.path.join(tmp, "p2"),
                     s1_pth)

    # AttnGAN at GF 4 / DF 4, embedding 16, R_NUM 1, two branches
    cfga = _yml(tmp, "coco_attn_eval.yml", "attn.yml",
                ("DF_DIM: 96", "DF_DIM: 4"), ("GF_DIM: 48", "GF_DIM: 4"),
                ("R_NUM: 3", "R_NUM: 1"), ("BRANCH_NUM: 3", "BRANCH_NUM: 2"),
                ("EMBEDDING_DIM: 256", "EMBEDDING_DIM: 16"))
    from multiple_objects_gan_tpu.cli.attngan_runner import build_all

    jmc, g, d_modules, _, _ = build_all(
        jconfig.cfg_from_file(cfga, "coco-attngan"), 20)
    sa = jcreate_attngan_state(jmc, g, d_modules, jax.random.PRNGKey(7),
                               batch_size=2, seq_len=20)
    sa = sa.replace(g_params=_jitter(sa.g_params, 11),
                    g_stats=_jitter(sa.g_stats, 12),
                    g_ema=_jitter(sa.g_ema, 13),
                    d_params=_jitter(sa.d_params, 14),
                    d_stats=_jitter(sa.d_stats, 15))
    _save_jax(sa, os.path.join(tmp, "ja"))
    pa = attngan_model_config(cfg_from_file(cfga, "coco-attngan"))
    psa = create_attngan_state(pa, device="cpu")
    psa.g.load_state_dict(w.attngan_g_state_dict_from_jax(
        sa.g_params, sa.g_stats, branch_num=2, r_num=1))
    ema = w.attngan_g_state_dict_from_jax(sa.g_ema, sa.g_stats,
                                          branch_num=2, r_num=1)
    with torch.no_grad():
        for k, v in psa.g_ema.items():
            v.copy_(ema[k])
    for name in D_NAMES[:2]:
        psa.ds[name].load_state_dict(w.attngan_d_state_dict_from_jax(
            sa.d_params[name], sa.d_stats[name], scale=int(name[1:])))
    CheckpointManager(os.path.join(tmp, "pa", "models")).save(EPOCH, psa)
    out["attngan"] = (cfga, os.path.join(tmp, "ja"), os.path.join(tmp, "pa"))
    return tmp, out


def _same(got, want, what):
    """Two state dicts: the same keys, every tensor equal bit for bit, of
    JAX's dtype, contiguous."""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert got[k].is_contiguous(), (what, k)
        if k.endswith("num_batches_tracked"):
            # torch's own 0-d buffer; JAX's goes through
            # np.ascontiguousarray, which makes it 1-d (torch loads both)
            assert got[k].shape == () and want[k].shape == (1,), (what, k)
            assert torch.equal(got[k].reshape(1), want[k]), (what, k)
            continue
        assert torch.equal(got[k], want[k]), (what, k)


def _same_file(got_path, want_path, bare):
    got, want = torch_load(got_path), torch_load(want_path)
    if bare:
        _same(got, want, got_path)
        return
    assert list(got) == list(want) == CONTAINER
    assert got["epoch"] == want["epoch"] == EPOCH
    assert got["optimG"] == want["optimG"] == {}
    assert got["optimD"] == want["optimD"] == {}
    _same(got["netG"], want["netG"], got_path + " netG")
    _same(got["netD"], want["netD"], got_path + " netD")


CASES = [
    ("stage1", ["--variant", "multi-mnist"], True),
    ("stage2", ["--s1_net_g"], True),
    ("stage2", [], False),
    ("attngan", [], True),
    ("attngan", ["--raw"], False),
    ("attngan", ["--bare"], False),
]


@pytest.mark.parametrize("family,flags,with_d", CASES,
                         ids=[f"{f}{''.join(x)}{'-out_d' if d else ''}"
                              for f, x, d in CASES])
def test_port_export_equals_jax_export(runs, family, flags, with_d, capsys):
    tmp, by_family = runs
    cfg, jrun, prun = by_family[family][:3]
    flags = list(flags)
    if flags == ["--s1_net_g"]:
        flags.append(by_family["stage2"][3])
    tag = "_".join([family, *[f.strip("-") for f in flags[:1]],
                    "d" if with_d else ""])
    paths = {}
    for side, run, main in (("jax", jrun, jax_tool.main),
                            ("port", prun, port_tool.main)):
        out = os.path.join(tmp, f"{tag}_{side}.pth")
        argv = [family, "--cfg", cfg, "--ckpt", run, "--out", out, *flags]
        if with_d:
            d_out = os.path.join(tmp, f"{tag}_{side}_d" + (
                "" if family == "attngan" else ".pth"))
            argv += ["--out_d", d_out]
        if side == "port":
            argv += ["--device", "cpu"]
        main(argv)
        paths[side] = (out, d_out if with_d else None)
    printed = capsys.readouterr().out
    if family == "stage2" and "--s1_net_g" not in flags:
        assert printed.count("WARNING: no --s1_net_g") == 2
    _same_file(paths["port"][0], paths["jax"][0], bare="--bare" in flags)
    if family == "stage2" and "--s1_net_g" in flags:
        keys = torch_load(paths["port"][0])["netG"]
        assert any(k.startswith("STAGE1_G.") for k in keys)
    if not with_d:
        return
    if family == "attngan":
        names = sorted(os.listdir(paths["port"][1]))
        assert names == sorted(os.listdir(paths["jax"][1])) == [
            "netD0.pth", "netD1.pth"]
        for n in names:
            _same_file(os.path.join(paths["port"][1], n),
                       os.path.join(paths["jax"][1], n), bare=True)
    else:
        _same_file(paths["port"][1], paths["jax"][1], bare=True)


def test_port_export_takes_an_epoch_and_the_models_dir(runs):
    tmp, by_family = runs
    cfg, _, prun = by_family["stage1"]
    out = os.path.join(tmp, "epoch.pth")
    port_tool.main(["stage1", "--cfg", cfg, "--ckpt",
                    os.path.join(prun, "models"), "--epoch", str(EPOCH),
                    "--out", out, "--device", "cpu"])
    assert torch_load(out)["epoch"] == EPOCH
    with pytest.raises(FileNotFoundError):
        port_tool.main(["stage1", "--cfg", cfg, "--ckpt",
                        os.path.join(tmp, "nothing"), "--out", out,
                        "--device", "cpu"])
