"""The program's own ranges over the traced slice, and its counters over
the window.

While a profiler runs, the program's flight recorder captures ranges at its
layer boundaries (``fei_tpu_torch.obs.flight``): the scheduler's admission
and decode dispatch, the model's forward, attention, MLP or MoE block and
head, the int8 weight casts, each with its parent and, for the MoE block
and the casts, its device time. The traced slice starts and stops the
profiler on the scheduler's loop thread, so the capture holds the slice's
loop iterations. A program without ranges gives None, and so does every
reader built on them.
"""

from __future__ import annotations


def captured() -> list[dict] | None:
    """The captured ranges (dicts: ``id``, ``name``, ``start_ns``,
    ``end_ns`` on the wall clock, ``parent``, ``device_ms``), or None."""
    try:
        from fei_tpu_torch.obs.flight import FLIGHT
    except ImportError:
        return None
    read = getattr(FLIGHT, "ranges", None)
    return read() if read is not None else None


def under(ranges: list[dict], name: str, ancestor: str) -> list[dict]:
    """The ranges called ``name`` that lie inside a range called
    ``ancestor``, at any depth."""
    by_id = {r["id"]: r for r in ranges}
    out = []
    for r in ranges:
        if r["name"] != name:
            continue
        p = by_id.get(r["parent"])
        while p is not None and p["name"] != ancestor:
            p = by_id.get(p["parent"])
        if p is not None:
            out.append(r)
    return out


def window_ms_per_step(view, counter: str) -> float | None:
    """The program's seconds counter ``counter`` over the window, in ms per
    decode step; None where the program has no such counter."""
    steps = view.delta("scheduler.decode_steps")
    if counter not in view.after or not steps:
        return None
    return 1e3 * view.delta(counter) / steps


def slice_decode_steps(view) -> float:
    """Decode steps the scheduler took in the traced slice."""
    sl = view.slice
    if sl is None:
        return 0.0
    key = "scheduler.decode_steps"
    return sl.counters1.get(key, 0.0) - sl.counters0.get(key, 0.0)


def decode_device_ms(view, name: str) -> float | None:
    """Device ms of the ``name`` ranges inside the slice's decode
    dispatches (``sched.decode``), per decode step of the slice; None where
    the program records no such range or one of them has no device time."""
    steps = slice_decode_steps(view)
    ranges = captured()
    if not steps or not ranges:
        return None
    picked = under(ranges, name, "sched.decode")
    if not picked or any(r["device_ms"] is None for r in picked):
        return None
    return sum(r["device_ms"] for r in picked) / steps
