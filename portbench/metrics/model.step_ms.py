"""Window seconds per decode step (admissions and merged prefill chunks
between steps included)."""


def read(view):
    steps = view.delta("scheduler.decode_steps")
    return 1e3 * view.window_s / steps if steps else None
