"""Packets of every step completed in the measured window, over the
window's host-clock seconds (closed loop: a step is complete when its
StepResult is in hand)."""


def read(rec):
    return rec["steps"] * rec["batch"] / rec["window_s"]
