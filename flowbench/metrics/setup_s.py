"""Seconds from the process's start to the window's: imports, the world
generated from the seed, the engine built from it (policy compile, tables,
canary), the traffic drawn, the warm-up steps (the first run in a checkout
also builds the kernels)."""


def read(rec):
    return rec["setup_s"]
