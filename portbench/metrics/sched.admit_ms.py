"""Admission's wall time between decode steps: the program's
``scheduler.admit_seconds`` (each admission call of the scheduler's loop,
prefills included) over the window, per decode step."""

from portbench.ranges import window_ms_per_step


def read(view):
    return window_ms_per_step(view, "scheduler.admit_seconds")
