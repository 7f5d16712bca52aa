"""Output tokens that reached the clients inside the window, per second
of the window."""


def read(view):
    n = sum(1 for r in view.records for t in r.stamps if view.w0 <= t <= view.w1)
    return n / view.window_s if n else None
