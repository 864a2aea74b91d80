"""Device ms a step of the kernels launched under the profiler's annotation of the
optimizer's step (AdamW's update of every leaf)."""

from harness.readers import device_ms_under

ANNOTATION = "Optimizer.step#AdamW.step"


def read(r):
    return device_ms_under(r, ANNOTATION)
