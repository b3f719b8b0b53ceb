"""The benchmark's configuration and mix files as the CPU tests run them:
read from flowbench/configs/ and flowbench/traffic/ themselves, with only
their counts cut to a test's size (Pods, Nodes, policies, Services, table
slots, batch and steps); every other key, name and share as the file has
it."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Counts the tests cut, by key: what a test's run holds on the CPU.
CLUSTER = {"pods_per_namespace": 600, "nodes": 12}
POLICIES = 60
SERVICES = {"count": 40, "no_endpoints": 1}
ENGINE = {"flow_slots": 1 << 11, "aff_slots": 1 << 5}
MIX = {"batch": 512, "new_per_step": 64, "life_steps": 4, "templates": 8,
       "warm_steps": 4}


def cut_config(cfg: dict, **engine) -> dict:
    """A configuration with its counts cut (engine: further engine keys,
    such as another aff_slots), in place -> it."""
    cfg["cluster"].update(CLUSTER)
    for p in cfg["policies"]:
        p["count"] = POLICIES
    if "services" in cfg:
        cfg["services"].update(SERVICES)
    cfg["engine"].update(ENGINE, **engine)
    return cfg


def cut_mix(m: dict) -> dict:
    """A mix with its counts cut, in place -> it."""
    m.update(MIX)
    return m


def config(name: str, **engine) -> dict:
    """flowbench/configs/<name>.json, its counts cut."""
    return cut_config(json.loads(
        (ROOT / "flowbench/configs" / f"{name}.json").read_text()), **engine)


def mix(name: str) -> dict:
    """flowbench/traffic/<name>.json, its counts cut."""
    return cut_mix(json.loads(
        (ROOT / "flowbench/traffic" / f"{name}.json").read_text()))
