"""Attention's share of its roofline in the traced slice: the least time
the slice's attention work needs (per prefill and per decode position,
the larger of its FLOPs at 989 TFLOP/s and its bytes, each input byte once,
at 3.35 TB/s, keys capped at the window) over the device time of the
kernels that do attention. Those kernels are named by the substrings in
``attn_kernels/*.txt``: a program that moves attention to another kernel
adds a file there."""

from pathlib import Path

from portbench.readers import slice_work

PATTERNS = [line.strip() for f in sorted((Path(__file__).parent / "attn_kernels").glob("*.txt"))
            for line in f.read_text().splitlines() if line.strip() and not line.startswith("#")]


def read(view):
    w = slice_work(view)
    if not w:
        return None
    busy = view.slice.kernel_seconds(PATTERNS)
    if not busy or not w["attn_least_s"]:
        return None
    return 100.0 * w["attn_least_s"] / busy
