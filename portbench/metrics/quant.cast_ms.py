"""Device time of the int8 weights' bf16 copies in the decode step (the
experts' and the attention linears'): the device ms of the program's
``quant.cast`` ranges inside its decode dispatches over the traced slice,
per decode step."""

from portbench.ranges import decode_device_ms


def read(view):
    return decode_device_ms(view, "quant.cast")
