"""The step's 3x3 convolutions, forward, data and weight gradients, at the roofline:
their least time (from the configuration's and the traffic's shapes, benchmarks/harness/
work.py) over the device time of the kernels that compute them, matched by name."""

from harness.readers import conv_roofline_pct

KERNELS = "conv3x3_halo_wgmma|conv3x3_dgrad_s2|conv3x3_wgrad|wgrad_reduce|conv3x3_f32_simt|wgrad_f32_simt|dgrad_s2_f32"


def read(r):
    return conv_roofline_pct(r, KERNELS)
