"""Share of the traced slice's device-idle time that falls inside the
model's forward: of the gaps between the device's busy intervals, the
share whose midpoint lies in one of the program's ``model.forward``
ranges (the rule the slice's breakdown names gaps by), that is the device
waiting on the host's launches of the forward."""

from portbench.ranges import captured
from portbench.trace import host_activity


def read(view):
    sl = view.slice
    ranges = captured()
    if sl is None or not sl.kernels or not ranges:
        return None
    forwards = [(r["name"], r["start_ns"], r["end_ns"]) for r in ranges
                if r["name"] == "model.forward"]
    busy = sl.busy()
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = sum(e - s for s, e in gaps)
    if not forwards or not idle:
        return None
    names = host_activity(forwards, [(s + e) // 2 for s, e in gaps])
    return sum(e - s for (s, e), n in zip(gaps, names) if n != "host") / idle
