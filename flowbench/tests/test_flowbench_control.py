"""The check's comparison is shown to fail: its control (the reference with
the flow cache's tuple compare left out, in the program's place), and a
run of the harness with the timed path broken underneath in each way the
cell can break, both come out not correct; in a world with Services also
a program that reports another endpoint than the one it committed, and
one whose endpoint choice is off by one.  (The cells run on one card:
there is no exchange between cards to leave out.)"""

import dataclasses
import time

import numpy as np
import pytest

from antrea_tpu_torch.models import pipeline as pl
from antrea_tpu_torch.packet import PacketBatch
from conftest import SMALL_MIX, SVC_MIX, service_config, small_config
from flowbench import harness
from flowbench.control import control_readings
from flowbench.world import build_world, plain_world

KINDS = ["small_ns", "one_ns", "service"]


def _cell(kind):
    if kind == "service":
        return service_config(), SVC_MIX
    return small_config(kind), SMALL_MIX


def _wrong(checks: dict) -> bool:
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 9])
@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(seed, kind):
    out = control_readings(*_cell(kind), seed, 24, "cpu")
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


def _endpoint_misreported(eng):
    """Reports, for each Service connection it commits, the next endpoint
    of the Service after the one it committed."""
    eps = [[(int(np.uint32(int.from_bytes(bytes(map(int, ip.split("."))),
                                          "big"))), port)
            for ip, port in v["endpoints"]]
           for v in plain_world(build_world(service_config()))["services"]]
    inner = eng.step

    def step(batch, now, **kw):
        r = inner(batch, now, **kw)
        ip, port = r.dnat_ip.copy(), r.dnat_port.copy()
        for i in np.nonzero((r.svc_idx >= 0) & (r.committed == 1)
                            & (r.reply == 0))[0]:
            e = eps[r.svc_idx[i]]
            k = e.index((int(ip[i]) & 0xFFFFFFFF, int(port[i])))
            ip[i], port[i] = e[(k + 1) % len(e)]
        return dataclasses.replace(r, dnat_ip=ip, dnat_port=port)
    eng.step = step


@pytest.mark.parametrize("kind,fault", [
    (k, f) for k in KINDS
    for f in (_state_unchanged, _half_batch, _answer_altered)] + [
    ("service", _endpoint_misreported)])
def test_broken_timed_path_is_not_correct(fault, kind):
    rec = harness.run_cell(*_cell(kind), 11, 0.5, False, "cpu",
                           time.perf_counter(), engine_hook=fault)
    assert rec["steps"] >= 1
    assert _wrong(harness.compare(rec, "cpu")["checks"])


def test_endpoint_choice_off_by_one_is_not_correct(monkeypatch):
    """The engine's LB picks the endpoint after the flow hash's, and
    commits and reports that one: its replies hit where the reference's
    miss."""
    inner = pl._service_lb

    def lb(aff, dsvc, h, *a, **kw):
        return inner(aff, dsvc, h + 1, *a, **kw)
    monkeypatch.setattr(pl, "_service_lb", lb)
    rec = harness.run_cell(*_cell("service"), 11, 0.5, False, "cpu",
                           time.perf_counter())
    checks = harness.compare(rec, "cpu")["checks"]
    assert checks["lanes_off"]["value"] > 0, checks
    assert checks["steps_miss_count_off"]["value"] > 0, checks


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(kind):
    rec = harness.run_cell(*_cell(kind), 11, 0.5, False, "cpu",
                           time.perf_counter())
    out = harness.compare(rec, "cpu")
    assert not _wrong(out["checks"])
    assert out["replies"]
