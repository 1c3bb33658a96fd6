"""``mdct_roofline``: the MDCT route's least time over its device time.

The least time of a call is, for each direction, the larger of one
[frames, N] x [N, N] product a row at the bf16 dense peak and the signal and
spectrum bytes once at the HBM rate (``lib/roofline.py``); the device time
is that of the route's device functions, below, in the traced window, over
the calls in it. It counts the same work whatever implementation runs it.
"""

import re

from portbench.lib import roofline

KERNELS = re.compile(
    r"(^|[^A-Za-z0-9_])(split_kernel|split_gemm_kernel|scatter_kernel"
    r"|tc_kernel|fold_rotate_kernel|butterfly_in_kernel"
    r"|butterfly_out_kernel)([^A-Za-z0-9_]|$)")


def is_mdct(name: str) -> bool:
    return KERNELS.search(name) is not None


def read(t):
    ms = t.device_ms(is_mdct)
    if not ms or not t.ops:
        return None
    n = t.config["filters_n"]
    rows = t.params["clips"] * t.config["channels"]
    blocks = t.params["samples"] // n
    least = (roofline.least_seconds(*roofline.mdct_analysis(rows, blocks, n))
             + roofline.least_seconds(
                 *roofline.mdct_synthesis(rows, blocks + 1, n)))
    return 100.0 * least * t.ops / (ms / 1e3)
