"""The whole serving step's share of the chip's bf16 peak over the traced
slice: the model FLOPs of every token prefilled or decoded in it (2 per
matmul weight, the picked experts only, the LM head once per sampled
position, and attention over each token's window) over slice seconds at
989 TFLOP/s."""

from portbench import roofline
from portbench.readers import slice_work


def read(view):
    w = slice_work(view)
    if not w or not (w["prefill_tokens"] + w["decode_tokens"]):
        return None
    flops = roofline.model_flops(view.model, w["prefill_tokens"] + w["decode_tokens"],
                                 w["heads"], w["attn_flops"])
    return 100.0 * flops / (view.slice.wall_s * roofline.PEAK_FLOPS)
