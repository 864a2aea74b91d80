"""Device ms a step of the kernels launched inside the program's ``ac::policy`` spans:
the actor-critic's forward calls in the rollout (the main evaluation, the final frame's
value, the burn-in after a reset, the bootstrap value)."""

from harness.readers import per_step_ms
from harness.spans import device_s_under

SPAN = "ac::policy"


def read(r):
    return per_step_ms(device_s_under(r.trace, SPAN), r.steps)
