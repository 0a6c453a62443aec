"""BatchNorm groups that span ranks (``nn/blocks.py``, ``--bn_groups G`` at
a world size W that does not divide G), as real processes on the CPU: a
process group over gloo on localhost (``tools/dist_steps.py:spawn``, the
cases of tests/torch_port_dist_cases.py), one start for each layout.

The JAX package groups contiguous chunks of the global batch whatever the
device count (its nn/blocks.py:95-104). Two layouts:

* G 3 over W 2 at global batch 12: chunk 1 is rows 4-7, two on each rank;
* G 2 over W 4 at global batch 8: each chunk is two ranks' rows.

For each, the mnist step at GF 16 / DF 8 (tests/test_torch_port_
multihost.py's case, both Adams warm as tests/test_torch_port_sync_bn.py
starts its groups case: 4 rows a group) equals the JAX step at
``BN_GROUPS = G`` on one device, at tests/test_torch_port_multihost.py's
criteria for that case (losses atol 1e-3, running statistics atol 5e-4,
per-tensor Adam-delta cosine > 0.999, mean |difference| < 0.02 lr, at
most 0.5 % flips); every rank ends with the same parameters and buffers,
bit for bit. D's conditional head sees the wrong pair, one row fewer on
the last rank, whose chunks torch.chunk cuts from 11 and 7 rows.

A plain BatchNorm2d at unequal local counts (6 and 5 rows; 2, 2, 2, 1) and
an object-pathway BatchNorm2d (3 objects folded O-minor; 6 rows a rank,
2 a rank) equal JAX's
``TorchBatchNorm`` under ``BN_GROUPS = G`` (and ``object_fold(3)``) on the
whole batch in float32: outputs and input gradients atol 1e-5, the weight
gradient summed over the ranks atol 1e-4 (a sum over 11 rows of 9 pixels),
and every rank's running statistics JAX's (chunk 0's update), atol 1e-5,
as tests/test_torch_port_bn_groups.py holds a layer against JAX.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_cases as cases
from multiple_objects_gan_tpu.io.torch_import import (
    import_stage1_d, import_stage1_g)
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.nn import blocks as jblocks
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.nn.blocks import set_bn_groups
from multiple_objects_gan_tpu_torch.tools import dist_steps
from multiple_objects_gan_tpu_torch.train.state import create_state
from test_step_parity import _layout_batch, _replay_step_noise
from test_torch_parity import _randomize
from test_torch_port_multihost import JCFG, PCFG, TESTS, WORKER_ENV
from test_torch_port_stage2_step import _warm_adam
from test_torch_port_step import _compare_deltas, _compare_stats

LR = 2e-4
# (groups, world, global batch of the step, local rows of the plain
# BatchNorm and of the object-pathway BatchNorm)
LAYOUTS = {"g3-w2": (3, 2, 12, (6, 5), (6, 6)),
           "g2-w4": (2, 4, 8, (2, 2, 2, 1), (2, 2, 2, 2))}
BN_ATOL = 1e-5
W_GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grouped_mnist(n: int, groups: int):
    """The mnist step case at global batch ``n`` and ``groups`` (weights
    as tests/test_torch_port_multihost.py:_mnist draws them, both Adams
    warm), and the JAX step's results under BN_GROUPS = ``groups``."""
    pcfg = dataclasses.replace(PCFG, bn_groups=groups)
    state = create_state(pcfg, device="cpu")
    _randomize(state.g, seed=3)
    _randomize(state.d, seed=11)
    sd_g = {k: v.numpy().copy() for k, v in state.g.state_dict().items()}
    sd_d = {k: v.numpy().copy() for k, v in state.d.state_dict().items()}
    g_params, g_stats = import_stage1_g({"netG": sd_g}, JCFG)
    d_params, d_stats = import_stage1_d(sd_d, JCFG)
    jg, jd = JStage1G(JCFG), JStage1D(JCFG)
    jstate = jcreate_state(JCFG, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    jstate = _warm_adam(state, jstate.replace(
        g_params=g_params, g_stats=g_stats, d_params=d_params,
        d_stats=d_stats))
    for m in (state.g, state.d):
        set_bn_groups(m, groups)
    bbox, onehot, rs = _layout_batch(n, 3, 10, seed=7)
    batch = {"image": rs.randint(0, 256, (n, 64, 64, 1)).astype(np.uint8),
             "bbox": bbox, "label_onehot": onehot}
    rng = jax.random.PRNGKey(42)
    z, _ = _replay_step_noise(rng, 0, n, JCFG.z_dim)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblocks, "BN_GROUPS", groups)
        new_jstate, metrics = jax.jit(jmake_train_step(JCFG, jg, jd))(
            jstate, jax.tree.map(jnp.asarray, batch), rng, jnp.float32(LR),
            jnp.float32(LR))
    case = {"name": "mnist", "kind": "stage1", "config": pcfg,
            "state": state, "seed": 0, "lr": LR,
            "z": torch.from_numpy(np.array(z)),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": stage1_g_state_dict_from_jax(new_jstate.g_params,
                                              new_jstate.g_stats, pcfg),
            "d": stage1_d_state_dict_from_jax(new_jstate.d_params,
                                              new_jstate.d_stats)}
    pre = {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
           "d": {k: v.clone() for k, v in state.d.state_dict().items()}}
    return case, want, pre


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every layout's ranks (one spawn each) and the JAX references."""
    out = {}
    for name, (groups, world, n, counts, obj_counts) in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(name)
        case, want, pre = _grouped_mnist(n, groups)
        path = str(tmp / "cases.pth")
        torch.save([case, {"name": "bn",
                           "call": "torch_port_dist_cases:span_bn_rank",
                           "kwargs": {"counts": counts,
                                      "object_counts": obj_counts,
                                      "groups": groups}}],
                   path)
        ranks = dist_steps.spawn(path, str(tmp / "out"), world=world,
                                 device="cpu", timeout=300,
                                 extra_path=(TESTS,),
                                 env={**os.environ, **WORKER_ENV})
        out[name] = {"ranks": ranks, "jax": want, "pre": pre}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spanning_groups_step_matches_jax_bn_groups(run, layout):
    got_run = run[layout]
    want = got_run["jax"]
    for r, rank in enumerate(got_run["ranks"]):
        got = rank["results"]["mnist"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-3,
                                       err_msg=f"rank {r} loss {k}")
        post = got["state"]
        _compare_stats(post["g"], want["g"], f"rank {r} g_stats")
        _compare_stats(post["d"], want["d"], f"rank {r} d_stats")
        _compare_deltas(got_run["pre"]["g"], post["g"], want["g"],
                        f"rank {r} G")
        _compare_deltas(got_run["pre"]["d"], post["d"], want["d"],
                        f"rank {r} D")
    first = got_run["ranks"][0]["results"]["mnist"]["state"]
    for rank in got_run["ranks"][1:]:
        for part in ("g", "d"):
            for k, v in first[part].items():
                assert torch.equal(v, rank["results"]["mnist"]["state"][
                    part][k]), (part, k)


def _jax_bn(kind, counts, groups, init):
    """JAX's TorchBatchNorm on the whole float32 batch under BN_GROUPS =
    ``groups`` (and object_fold(3)): output, input gradient and weight
    gradient of sum(y * w), NCHW, and the new running statistics."""
    inp = {k: v.float().numpy() for k, v in cases.bn_input(counts).items()}
    x, w = (inp["x"], inp["w"]) if kind == "plain" else (inp["xo"],
                                                         inp["wo"])
    params = {"scale": jnp.asarray(init["weight"].numpy()),
              "bias": jnp.asarray(init["bias"].numpy())}
    stats = {"mean": jnp.asarray(init["running_mean"].numpy()),
             "var": jnp.asarray(init["running_var"].numpy())}
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    wh = jnp.asarray(w.transpose(0, 2, 3, 1))
    fold = 3 if kind == "object" else 1

    def apply(p, xx):
        with jblocks.object_fold(fold):
            return jblocks.TorchBatchNorm().apply(
                {"params": p, "batch_stats": stats}, xx, train=True,
                mutable=["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblocks, "BN_GROUPS", groups)
        y, new = apply(params, xh)
        grads = jax.grad(lambda p, xx: (apply(p, xx)[0] * wh).sum(),
                         argnums=(0, 1))(params, xh)
    nchw = (0, 3, 1, 2)
    return {"y": np.asarray(y).transpose(nchw),
            "x_grad": np.asarray(grads[1]).transpose(nchw),
            "w_grad": np.asarray(grads[0]["scale"]),
            "running_mean": np.asarray(new["batch_stats"]["mean"]),
            "running_var": np.asarray(new["batch_stats"]["var"])}


@pytest.mark.parametrize("kind", ["plain", "object"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spanning_groups_batchnorm_matches_jax(run, layout, kind):
    groups, _, _, plain_counts, obj_counts = LAYOUTS[layout]
    counts = plain_counts if kind == "plain" else obj_counts
    ranks = run[layout]["ranks"]
    init = ranks[0]["results"]["bn"]["value"][kind]["init"]
    want = _jax_bn(kind, counts, groups, init)
    scale = 3 if kind == "object" else 1
    lo, w_grad = 0, 0
    for r, n in enumerate(counts):
        got = ranks[r]["results"]["bn"]["value"][kind]
        rows = slice(scale * lo, scale * (lo + n))
        for k in ("y", "x_grad"):
            np.testing.assert_allclose(got[k].numpy(), want[k][rows],
                                       atol=BN_ATOL, err_msg=f"{r} {k}")
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       atol=BN_ATOL, err_msg=f"{r} {k}")
        w_grad = w_grad + got["w_grad"]
        lo += n
    np.testing.assert_allclose(w_grad.numpy(), want["w_grad"],
                               atol=W_GRAD_ATOL)
