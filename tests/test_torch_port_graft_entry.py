"""The port's driver entries (``multiple_objects_gan_tpu_torch/
graft_entry.py``) and the stage-2 step across ranks
(``tools/dist_steps.py``'s ``"stage2"`` case) on the CPU.

* ``entry()`` at GF 16 / DF 8 against the JAX package's own
  ``__graft_entry__.entry()`` at the same widths (its ``common.MNIST``
  replaced for the call; nothing of the JAX package is edited): the two
  batches bit for bit; the JAX entry's state carried into the port through
  ``io/weights.py``, the JAX step's z replayed
  (tests/test_step_parity.py:_replay_step_noise); ``d_loss``, ``g_loss``,
  G's parameters and the BatchNorm running statistics after the step held
  with tests/test_torch_port_step.py's criteria (losses atol 1e-3,
  statistics atol 5e-4, per-tensor Adam-delta cosine > 0.999, mean
  |difference| < 0.02 lr, at most 0.5 % of the elements apart by more
  than 0.5 lr).
* The dry run (``dryrun_multichip``'s legs and checks, as ``chip_smoke.py``
  phase 53 runs them): one start of two gloo ranks runs the three legs,
  and ``check_dryrun`` prints their OK lines. The JAX references
  compute in a thread meanwhile, to keep the file near 40 s (this process
  waits on the ranks). In the same start rides
  a stage-2 case at tests/test_torch_port_stage2_step.py's sizes
  (He-scale weights, warm Adams, batch 4, the JAX step's z and CA draws
  replayed): world 2 against world 1 (``dist_steps.run_cases`` in this
  process) and world 1 against JAX's one-device
  ``make_stage2_train_step`` from the same state, with that file's
  criteria; the replicas equal bit for bit.

Both entries' Adams start warm (tests/test_torch_port_stage2_step.py:
_warm_adam), where the update is linear in the gradient: from the fresh
Adams of ``create_state`` a first update is lr * sign(g), and at the JAX
entry's init G's ``fc.0.weight`` then reads a delta cosine of 0.9977
against JAX from float32 noise on near-zero gradients.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import math
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import __graft_entry__ as jentry  # noqa: E402
import chip_smoke  # noqa: E402
from multiple_objects_gan_tpu.models import common as jcommon  # noqa: E402
from multiple_objects_gan_tpu.models.stage1 import (  # noqa: E402
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.io import torch_import as ti  # noqa: E402
from multiple_objects_gan_tpu.models.stage2 import (  # noqa: E402
    Stage2D as JStage2D, Stage2G as JStage2G)
from multiple_objects_gan_tpu.train.state import (  # noqa: E402
    GANTrainState as JGANTrainState)
from multiple_objects_gan_tpu.train.step import (  # noqa: E402
    make_optimizer as jmake_optimizer,
    make_stage2_train_step as jmake_stage2_train_step,
    make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch import graft_entry  # noqa: E402
from multiple_objects_gan_tpu_torch.io.weights import (  # noqa: E402
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax,
    stage2_d_state_dict_from_jax, stage2_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common  # noqa: E402
from multiple_objects_gan_tpu_torch.tools import dist_steps  # noqa: E402
from multiple_objects_gan_tpu_torch.models.stage1 import (  # noqa: E402
    build_stage1_g)
from multiple_objects_gan_tpu_torch.train.state import (  # noqa: E402
    create_state, create_state_stage2)
from test_step_parity import _replay_step_noise  # noqa: E402
from test_torch_port_stage2_step import (  # noqa: E402
    JS1, JS2, KL_COEFF, PS1, PS2, R_NUM, _he_randomize, _noise, _warm_adam,
    stage2_batch)
from test_torch_port_step import (  # noqa: E402
    _compare_deltas, _compare_stats, _is_param)
from test_torch_port_clevr import (  # noqa: E402
    _compare_deltas as _compare_s2_deltas, _stats_close)

JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=16, df_dim=8)
PCFG = dataclasses.replace(common.MNIST, gf_dim=16, df_dim=8)
LR = graft_entry.LR
S2_B = 4                  # the stage-2 case's global batch: 2 a rank
ZERO_UPDATE = 1e-6 * LR    # an update this small is a zero gradient's
WORKER_ENV = {"OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- entry()


def _port_stage2_case():
    """The stage-2 case: tests/test_torch_port_stage2_step.py:_states(5, 3,
    11)'s port weights, warm Adams, batch 4 and the JAX step's z and CA
    draws (rng 42), without JAX's state (built later, beside the ranks)."""
    g1 = _he_randomize(build_stage1_g(PS1, seed=0, device="cpu"), 5)
    state = create_state_stage2(PS2, seed=0, device="cpu")
    _he_randomize(state.g, 3)
    _he_randomize(state.d, 11)
    chip_smoke.warm_adam(state)
    z, eps1, eps2 = _noise(jax.random.PRNGKey(42), S2_B)
    return {"name": "stage2_jax", "kind": "stage2", "config": PS2,
            "s1_config": PS1, "g1": g1.state_dict(), "state": state,
            "batch": {k: torch.from_numpy(v)
                      for k, v in stage2_batch(21, S2_B).items()},
            "z": z, "eps1": eps1, "eps2": eps2, "seed": 0, "lr": LR,
            "kl_coeff": KL_COEFF}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references (JAX's entry and stage-2 step), computed in a
    thread: ``jax_refs()`` waits for {"entry": ..., "stage2": ...}."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(lambda: {"entry": _jax_entry(),
                                  "stage2": _jax_stage2(_port_stage2_case())})
    try:
        yield lambda: future.result(timeout=600)
    finally:
        pool.shutdown(wait=True)


def _jax_entry():
    """JAX's entry() at GF 16 / DF 8 with warm Adams: its batch and rng,
    its fn's return and, in the same jit, the new state of the same step
    (JAX's make_train_step on the same arguments)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "MNIST", JCFG)
        fn, (state, batch, rng) = jentry.entry()
    port = create_state(
        PCFG, device="cpu",
        g_state_dict=stage1_g_state_dict_from_jax(state.g_params,
                                                  state.g_stats, PCFG),
        d_state_dict=stage1_d_state_dict_from_jax(state.d_params,
                                                  state.d_stats))
    state = _warm_adam(port, state)
    step = jmake_train_step(JCFG, JStage1G(JCFG), JStage1D(JCFG))
    (d_loss, g_loss, g_params), (new_state, metrics) = jax.jit(
        lambda s, b, r: (fn(s, b, r), step(s, b, r, jnp.float32(LR),
                                           jnp.float32(LR))))(
            state, batch, rng)
    return {"port": port, "state": state, "batch": batch, "rng": rng,
            "d_loss": float(d_loss), "g_loss": float(g_loss),
            "g_params": g_params, "new_state": new_state,
            "metrics": metrics}


def _compare_entry_deltas(pre, post, want, what):
    """tests/test_torch_port_step.py:_compare_deltas, where a parameter
    whose updates on both sides stay below ZERO_UPDATE is held equal at
    that atol instead: the entry's layouts are all alike, so the
    BatchNorms of G's layout encoder see equal rows and its gradient is
    zero but for rounding (updates of 1e-9 lr), whose cosine means
    nothing."""
    params = [k for k in pre if _is_param(k)]
    still = [k for k in params
             if float((post[k] - pre[k]).abs().max()) < ZERO_UPDATE
             and float((want[k] - pre[k]).abs().max()) < ZERO_UPDATE]
    for k in still:
        np.testing.assert_allclose(want[k].numpy(), post[k].numpy(),
                                   atol=ZERO_UPDATE, err_msg=f"{what}:{k}")
    assert all(k.startswith("bbox_net.") for k in still), still
    _compare_deltas({k: v for k, v in pre.items() if k not in still}, post,
                    want, what)


@pytest.fixture(scope="module")
def jax_entry(jax_refs, dryrun):
    return jax_refs()["entry"]


def test_entry_batch_equals_jax_bit_for_bit(jax_entry):
    _, (_, batch, _) = graft_entry.entry("cpu", PCFG)
    want = jax_entry["batch"]
    assert sorted(batch) == sorted(want)
    for k, v in want.items():
        got = batch[k].numpy()
        assert got.dtype == np.float32 and got.shape == v.shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert batch["image"].shape == (graft_entry.ENTRY_BATCH, 64, 64, 1)


def test_entry_step_matches_jax_entry(jax_entry):
    """The port's entry step from JAX's entry state, at JAX's z: losses,
    G's parameters (the entry's return) and every running statistic."""
    js = jax_entry["state"]
    fn, (_, batch, gen) = graft_entry.entry("cpu", PCFG)
    state = jax_entry["port"]          # JAX's entry state, warm Adams
    pre_g = {k: v.clone() for k, v in state.g.state_dict().items()}
    pre_d = {k: v.clone() for k, v in state.d.state_dict().items()}
    z, _ = _replay_step_noise(jax_entry["rng"], 0, graft_entry.ENTRY_BATCH,
                              JCFG.z_dim)
    d_loss, g_loss, params = fn(state, batch, gen,
                                z=torch.from_numpy(np.array(z)))
    assert state.step == 1
    np.testing.assert_allclose(float(d_loss), jax_entry["d_loss"], atol=1e-3)
    np.testing.assert_allclose(float(g_loss), jax_entry["g_loss"], atol=1e-3)
    # the entry's returned G against JAX's returned g_params
    want_g = stage1_g_state_dict_from_jax(jax_entry["g_params"], js.g_stats,
                                          PCFG)
    assert sorted(params) == sorted(k for k, p in state.g.named_parameters())
    post_g = {**pre_g, **params}
    _compare_entry_deltas(pre_g, post_g, want_g, "G (returned)")
    # the state after the step against JAX's new state: statistics and D
    new = jax_entry["new_state"]
    np.testing.assert_allclose(float(jax_entry["metrics"]["d_loss"]),
                               jax_entry["d_loss"], rtol=1e-6)
    want_g = stage1_g_state_dict_from_jax(new.g_params, new.g_stats, PCFG)
    want_d = stage1_d_state_dict_from_jax(new.d_params, new.d_stats)
    _compare_stats(state.g.state_dict(), want_g, "g_stats")
    _compare_stats(state.d.state_dict(), want_d, "d_stats")
    _compare_entry_deltas(pre_d, state.d.state_dict(), want_d, "D")


# ------------------------------------------- the dry run and stage 2


def _jax_stage2_state(case):
    """JAX's warm stage-2 state and stage-1 variables holding the case's
    weights, imported as tests/test_torch_port_stage2_step.py:_states
    imports them; the Adams from ``make_optimizer().init`` (what
    ``create_state_stage2`` holds, without its Flax init), then warm."""
    g1 = build_stage1_g(PS1, case["g1"], device="cpu")
    port = create_state_stage2(PS2, seed=0, device="cpu")
    port.load_checkpoint_dict(case["state"].checkpoint_dict())

    def numpy(m, prefix=""):
        return {prefix + k: v.numpy().copy()
                for k, v in m.state_dict().items()}

    s1, (g_params, g_stats) = ti.import_stage2_g(
        {"netG": {**numpy(g1, "STAGE1_G."), **numpy(port.g)}}, JS1, JS2,
        r_num=R_NUM)
    d_params, d_stats = ti.import_stage2_d(numpy(port.d))
    tx = jmake_optimizer()
    jstate = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params,
        d_params=d_params, g_stats=g_stats, d_stats=d_stats,
        g_opt=tx.init(g_params), d_opt=tx.init(d_params))
    return _warm_adam(port, jstate), {"params": s1[0], "batch_stats": s1[1]}


def _jax_stage2(case):
    """JAX's one-device stage-2 step on the case's weights, batch and
    draws (rng 42)."""
    jstate, s1_vars = _jax_stage2_state(case)
    batch = {k: v.numpy() for k, v in case["batch"].items()}
    with jax.default_matmul_precision("highest"):
        new_jstate, metrics = jax.jit(jmake_stage2_train_step(
            JS2, JS1, JStage1G(JS1), JStage2G(JS2, r_num=R_NUM),
            JStage2D(JS2), kl_coeff=KL_COEFF))(
                jstate, s1_vars, jax.tree.map(jnp.asarray, batch),
                jax.random.PRNGKey(42), jnp.float32(LR), jnp.float32(LR))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": stage2_g_state_dict_from_jax(new_jstate.g_params,
                                              new_jstate.g_stats, PS2.r_num),
            "d": stage2_d_state_dict_from_jax(new_jstate.d_params,
                                              new_jstate.d_stats)}


@pytest.fixture(scope="module")
def dryrun(jax_refs):
    """dryrun_multichip(2)'s legs (graft_entry.dryrun_cases) as two ranks
    on the CPU with the stage-2 case riding in the same start, checked by
    graft_entry.check_dryrun (its printed lines kept), then the case at
    world 1; the JAX references compute in their thread meanwhile."""
    case = _port_stage2_case()
    pre = copy.deepcopy(case["state"].checkpoint_dict())
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        path = os.path.join(tmp, "cases.pth")
        torch.save([*graft_entry.dryrun_cases(2), case], path)
        ranks = dist_steps.spawn(path, os.path.join(tmp, "out"), world=2,
                                 device="cpu", timeout=300,
                                 env={**os.environ, **WORKER_ENV})
    with contextlib.redirect_stdout(out):
        results = graft_entry.check_dryrun(ranks, 2)
    one = dist_steps.run_cases([case], "cpu")["stage2_jax"]
    return {"results": results, "out": out.getvalue(), "one": one,
            "jax": jax_refs()["stage2"], "pre": pre, "ranks": ranks}


def test_dryrun_multichip_spawns_the_legs_and_checks_them(dryrun,
                                                          monkeypatch,
                                                          capsys):
    """dryrun_multichip(n, device) hands dryrun_cases(n) to
    dist_steps.spawn at world n on the device (stubbed here with the
    fixture's ranks, whose start ran the same legs) and checks them."""
    seen = {}

    def spawn(path, out_dir, world=2, device="cuda", **kw):
        seen.update(names=[c["name"] for c in torch.load(
            path, weights_only=False)], world=world, device=device, kw=kw)
        return dryrun["ranks"]

    monkeypatch.setattr(dist_steps, "spawn", spawn)
    results = graft_entry.dryrun_multichip(2, device="cpu")
    assert seen == {"names": list(graft_entry.DRY_LEGS), "world": 2,
                    "device": "cpu", "kw": {}}
    assert capsys.readouterr().out == dryrun["out"]
    assert list(results) == [*graft_entry.DRY_LEGS, "stage2_jax"]


def test_dryrun_prints_the_three_ok_lines(dryrun):
    lines = dryrun["out"].splitlines()
    assert [ln.split()[1:3] for ln in lines] == [
        [leg, "OK"] for leg in graft_entry.DRY_LEGS]
    assert all(ln.startswith("dryrun_multichip(2) ") for ln in lines)
    res = dryrun["results"]
    for leg in graft_entry.DRY_LEGS:
        assert len(res[leg]) == 2
        assert all(math.isfinite(v) for v in res[leg][0]["metrics"].values())
        assert graft_entry.same_bits(res[leg][0]["state"],
                                     res[leg][1]["state"])
    assert "d_loss_d256" in res["attngan"][0]["metrics"]
    assert "kl_loss" in res["stage2"][0]["metrics"]
    # every leg stepped once from step 0
    assert all(res[leg][0]["state"]["step"] == 1
               for leg in ("stage1", "stage2"))


def _held(got: dict, want: dict, pre: dict, what: str):
    """tests/test_torch_port_stage2_step.py's criteria: losses atol 1e-3,
    running statistics atol 5e-4, the Adam deltas of G2 and D2."""
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, atol=1e-3,
                                   err_msg=f"{what} loss {k}")
    for net in ("g", "d"):
        _stats_close(got["state"][net], want[net], f"{what} {net}_stats",
                     atol=5e-4)
        _compare_s2_deltas(pre[net], got["state"][net], want[net],
                           f"{what} {net.upper()}2")


def test_stage2_world2_matches_world1(dryrun):
    ranks = dryrun["results"]["stage2_jax"]
    one = dryrun["one"]
    want = {"metrics": one["metrics"], **one["state"]}
    for r, got in enumerate(ranks):
        _held(got, want, dryrun["pre"], f"rank {r}")
        assert got["state"]["step"] == 1
    assert graft_entry.same_bits(ranks[0]["state"], ranks[1]["state"])


def test_stage2_world1_matches_jax(dryrun):
    _held(dryrun["one"], dryrun["jax"], dryrun["pre"], "world 1")
    np.testing.assert_allclose(
        dryrun["one"]["metrics"]["g_loss_total"],
        dryrun["one"]["metrics"]["g_loss"]
        + KL_COEFF * dryrun["one"]["metrics"]["kl_loss"], rtol=1e-6)


@pytest.mark.parametrize("zero_rel, fails", [(0.0, True), (1e-5, False)],
                         ids=["cosine", "zero-gradient"])
def test_smoke_entry_check_counts_rounding_gradients_as_zero(zero_rel,
                                                             fails):
    """chip_smoke.py phase 53 holds the entry's step with phase 8's
    limits, where a tensor whose gradient is within ENTRY_ZERO_REL of its
    net's largest on both sides (G's layout encoder under the entry's
    equal layouts) counts as zero instead of by its cosine; a real
    gradient that disagrees still fails."""
    g = torch.Generator().manual_seed(0)
    big = torch.randn(64, generator=g)

    def result(noise_seed, flip=False):
        noise = torch.randn(8, generator=torch.Generator().manual_seed(
            noise_seed)) * 1e-7
        grads = {"G": {"w": -big if flip else big, "enc": noise}}
        stats = {"G": {"bn.running_mean": torch.zeros(3)}}
        return ({"d_loss": 1.0}, stats, stats, grads, 0.0)

    bad, worst = chip_smoke.step_disagreements(result(1), result(2),
                                               zero_rel=zero_rel)
    assert bool(bad) == fails, bad
    assert worst["zero_grads"] == ([] if fails else ["G:enc"])
    bad, _ = chip_smoke.step_disagreements(result(1, flip=True), result(2),
                                           zero_rel=zero_rel)
    assert any(m.startswith("G:w gradient cosine") for m in bad)
    assert chip_smoke.ENTRY_ZERO_REL == 1e-5


def test_smoke_records_every_place_of_a_step():
    """chip_smoke.py phase 53 holds K1/K2 on the inputs recorded from a
    dry-run rank's step: the recorder sees each forward and backward of
    StnPlaceMulti once, with its inputs, and puts the functions back."""
    k1 = chip_smoke.k1
    before = (k1._place_cuda, k1.stn_place_multi_plain,
              k1.stn_place_multi_grad_nchw)
    x = torch.randn(2, 3, 4, 15, 15, requires_grad=True)
    bbox = torch.tensor([[0.1, 0.2, 0.3, 0.4]] * 3).expand(2, 3, 4)
    with chip_smoke.recorded_places() as calls:
        k1.stn_place_multi_nchw(x, bbox, (16, 16)).square().sum().backward()
    assert [(k, tuple(t.shape), hw) for k, t, _, hw in calls] == [
        ("place", (2, 3, 4, 15, 15), (16, 16)),
        ("grad", (2, 4, 16, 16), (15, 15))]
    assert torch.equal(calls[0][1], x.detach())
    assert torch.equal(calls[0][2], bbox) and not calls[0][1].requires_grad
    assert (k1._place_cuda, k1.stn_place_multi_plain,
            k1.stn_place_multi_grad_nchw) == before
