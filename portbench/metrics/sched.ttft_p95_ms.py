"""The scheduler's TTFT tail: 95th percentile over every request due in
the window, from when it was due, as the client saw it."""

from portbench.readers import nearest_rank, window_ttfts


def read(view):
    v = nearest_rank(window_ttfts(view), 95)
    return None if v is None else v * 1e3
