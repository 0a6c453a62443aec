"""chip_smoke.py's timing helpers on the CPU: the rotation of input copies
on which K1 and K2 are timed cold (``cold_sets``, ``run_ms``,
``in_turns``), with CUDA events replaced by a stand-in.

* ``cold_sets`` makes enough copies that a rotation reads more than the
  stated bytes (COLD_BYTES, twice the card's 50 MB L2) before it reuses a
  set, and no more than that needs; the first set is the caller's tensors.
* ``run_ms`` hands call k, warm-up included, the set k modulo the count,
  so every set is visited in order; without sets it calls with no
  arguments, as the warm readings and K4's timing do.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke


class _Event:
    """torch.cuda.Event's stand-in: every span reads 1 ms."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(chip_smoke.torch.cuda, "Event", _Event)
    monkeypatch.setattr(chip_smoke.torch.cuda, "synchronize", lambda: None)


def test_cold_bytes_exceed_twice_the_l2():
    assert chip_smoke.COLD_BYTES >= 2 * 50 * 2**20


@pytest.mark.parametrize("read_bytes", [7 * 2**20, 28 * 2**20, 50 * 2**20,
                                        100 * 2**20, 101 * 2**20,
                                        300 * 2**20])
def test_cold_sets_read_more_than_the_stated_bytes(read_bytes):
    x, bb = torch.zeros(4), torch.ones(2)
    sets = chip_smoke.cold_sets((x, bb), read_bytes)
    n = len(sets)
    assert n >= 2
    assert n * read_bytes > chip_smoke.COLD_BYTES
    assert n == 2 or (n - 1) * read_bytes <= chip_smoke.COLD_BYTES
    assert sets[0][0] is x and sets[0][1] is bb
    for s in sets[1:]:
        assert all(torch.equal(a, b) for a, b in zip(s, sets[0]))
        assert s[0].data_ptr() != x.data_ptr()
    assert len({s[0].data_ptr() for s in sets}) == n


def test_run_ms_visits_every_set_in_order(no_card):
    sets = [(k, f"box{k}") for k in range(3)]
    seen = []
    ms = chip_smoke.run_ms(lambda i, name: seen.append((i, name)),
                           warmup=2, runs=7, sets=sets)
    assert seen == [sets[k % 3] for k in range(9)]
    assert ms == pytest.approx(1.0 / 7)


def test_run_ms_without_sets_calls_with_no_arguments(no_card):
    calls = []
    chip_smoke.run_ms(lambda: calls.append(()), warmup=1, runs=3)
    assert calls == [()] * 4


def test_in_turns_rotates_in_every_turn(no_card):
    sets = [(k,) for k in range(4)]
    seen = {"plain": [], "kernel": []}
    out = chip_smoke.in_turns(
        [("plain", lambda k: seen["plain"].append(k)),
         ("kernel", lambda k: seen["kernel"].append(k)),
         ("kernel", lambda k: seen["kernel"].append(k)),
         ("plain", lambda k: seen["plain"].append(k))],
        warmup=1, runs=5, sets=sets)
    assert list(out) == ["plain", "kernel"]
    assert len(out["plain"]) == len(out["kernel"]) == 2
    one_turn = [k % 4 for k in range(6)]
    assert seen["plain"] == one_turn * 2
    assert seen["kernel"] == one_turn * 2
