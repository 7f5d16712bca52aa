"""Host time issuing the decode step: the program's
``scheduler.dispatch_issue_seconds`` (each paged decode dispatch's call
until its launches were queued) over the window, per decode step."""

from portbench.ranges import window_ms_per_step


def read(view):
    return window_ms_per_step(view, "scheduler.dispatch_issue_seconds")
