"""Device ms a step of the kernels launched inside the program's ``wm::transition``
spans: the world model's transitions in imagination (the denoiser's sampling passes,
the rew/end model, the frame buffers' roll)."""

from harness.readers import per_step_ms
from harness.spans import device_s_under

SPAN = "wm::transition"


def read(r):
    return per_step_ms(device_s_under(r.trace, SPAN), r.steps)
