"""``train.mfu``: the training steps' FLOPs in the traced window, counted
from shapes (``lib/roofline_train.py``), over the window's seconds times
the card's bf16 dense peak (``lib/roofline.py``). Each product is charged
once, so it cannot read above 100%."""

from portbench.lib import roofline, roofline_train, trace


def read(t):
    if not t.ops or not t.summary["device"]:
        return None
    flops = sum(roofline_train.step_flops(t.config, t.params).values())
    seconds = trace.window_us(t.summary) * 1e-6
    return 100.0 * flops * t.ops / (seconds * roofline.PEAK_BF16_FLOPS)
