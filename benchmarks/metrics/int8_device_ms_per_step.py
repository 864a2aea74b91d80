"""Device ms a step of the int8 sites' kernels: K4 (the quantizing norms), K5 (the int8
3x3 conv) and K6 (the int8 1x1/dense product), matched by name."""

from harness.readers import device_ms_matching

# K6; K5 (int8 codes in: the first template argument); K4 (the norm kernel's int8-out
# instance, its second template argument true)
KERNELS = r"matmul_q8|conv3x3_halo_wgmma<signed char|gn_cluster_kernel<[^,>]*, true>"


def read(r):
    return device_ms_matching(r, KERNELS)
