"""The whole step against the chip's peak: the operations its forward and backward need
(2 per multiply-add, from the configuration's shapes; bf16 at 989 TFLOP/s, the int8
sites at 1,979 TOP/s), as least time, over the window's wall time."""

from harness.readers import mfu_pct


def read(r):
    return mfu_pct(r)
