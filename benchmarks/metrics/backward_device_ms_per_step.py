"""Device ms a step of the kernels launched inside the program's ``train::backward``
span: the train step's backward pass (autograd's thread launches them while the span
is open on the caller's)."""

from harness.readers import per_step_ms
from harness.spans import device_s_under

SPAN = "train::backward"


def read(r):
    return per_step_ms(device_s_under(r.trace, SPAN), r.steps)
