"""Device time of the MoE block in the decode step: the device ms of the
program's ``model.moe`` ranges inside its decode dispatches over the
traced slice, per decode step."""

from portbench.ranges import decode_device_ms


def read(view):
    return decode_device_ms(view, "model.moe")
