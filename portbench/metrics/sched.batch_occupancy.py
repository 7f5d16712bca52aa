"""Share of the decode rows that carried a live request, over the
window's decode steps (the scheduler's own counters)."""


def read(view):
    steps = view.delta("scheduler.decode_steps")
    if not steps:
        return None
    return view.delta("scheduler.decode_slot_steps") / (steps * view.rows)
