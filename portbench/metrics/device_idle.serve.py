"""Share of the traced slice in which no operation ran on the device."""


def read(view):
    sl = view.slice
    if sl is None or not sl.kernels:
        return None
    return (1.0 - sl.busy_s() / sl.wall_s)
