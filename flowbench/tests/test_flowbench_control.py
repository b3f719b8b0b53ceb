"""The check's comparison is shown to fail: its control (the reference with
the flow cache's tuple compare left out, in the program's place), and a
run of the harness with the timed path broken underneath in each way the
cell can break, both come out not correct.  (The cells run on one card:
there is no exchange between cards to leave out.)"""

import dataclasses
import time

import numpy as np
import pytest

from antrea_tpu_torch.models import pipeline as pl
from antrea_tpu_torch.packet import PacketBatch
from conftest import SMALL_MIX, small_config
from flowbench import harness
from flowbench.control import control_readings


def _wrong(checks: dict) -> bool:
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 9])
@pytest.mark.parametrize("kind", ["small_ns", "one_ns"])
def test_control_is_not_correct(seed, kind):
    out = control_readings(small_config(kind), SMALL_MIX, seed, 24, "cpu")
    assert _wrong(out["checks"]), out


def _state_unchanged(eng):
    inner = eng.step

    def step(batch, now, **kw):
        saved = pl.clone_state(eng._state)
        r = inner(batch, now, **kw)
        eng._state = saved
        return r
    eng.step = step


def _half_batch(eng):
    """Steps the first half of each batch and answers the second half
    with the first half's results."""
    inner = eng.step

    def step(batch, now, **kw):
        h = batch.size // 2
        sub = PacketBatch(**{f.name: (None if getattr(batch, f.name) is None
                                      else getattr(batch, f.name)[:h])
                             for f in dataclasses.fields(batch)})
        r = inner(sub, now, **kw)
        out = {}
        for f in dataclasses.fields(r):
            v = getattr(r, f.name)
            if isinstance(v, np.ndarray):
                v = np.concatenate([v, v])
            elif isinstance(v, list):
                v = v + v
            elif f.name == "n_miss":
                v = 2 * v
            out[f.name] = v
        return dataclasses.replace(r, **out)
    eng.step = step


def _answer_altered(eng):
    inner = eng.step

    def step(batch, now, **kw):
        r = inner(batch, now, **kw)
        code = r.code.copy()
        code[len(code) // 3] ^= 1
        return dataclasses.replace(r, code=code)
    eng.step = step


@pytest.mark.parametrize("kind", ["small_ns", "one_ns"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_broken_timed_path_is_not_correct(fault, kind):
    rec = harness.run_cell(small_config(kind), SMALL_MIX, 11, 0.5, False, "cpu",
                           time.perf_counter(), engine_hook=fault)
    assert rec["steps"] >= 1
    assert _wrong(harness.compare(rec, "cpu")["checks"])


@pytest.mark.parametrize("kind", ["small_ns", "one_ns"])
def test_sound_run_is_correct(kind):
    rec = harness.run_cell(small_config(kind), SMALL_MIX, 11, 0.5, False, "cpu",
                           time.perf_counter())
    assert not _wrong(harness.compare(rec, "cpu")["checks"])
