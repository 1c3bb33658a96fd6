"""``codec.other_device_ms``: device ms a call of every device function
that is not one of the MDCT route's kernels (those ``mdct_roofline``
names): the psychoacoustic model's and the quantizer's torch ops, and any
copy."""


def read(t):
    if not t.ops or not t.summary["device"]:
        return None
    return t.device_ms(exclude=t.metric("mdct_roofline").is_mdct) / t.ops
