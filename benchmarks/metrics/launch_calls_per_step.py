"""Kernel launch calls a step: the profiler's cudaLaunchKernel and cudaLaunchKernelExC
calls in the traced window over its steps (host dispatch, eager PyTorch)."""

from harness.readers import launch_calls_per_step


def read(r):
    return launch_calls_per_step(r)
