"""Idle ms a step that the host leaves inside the program's ``ac::rollout`` span: the
window's idle gaps whose closing kernel was launched inside the rollout (host dispatch
between the imagined steps' kernels)."""

from harness.readers import per_step_ms
from harness.spans import idle_s_under

SPAN = "ac::rollout"


def read(r):
    return per_step_ms(idle_s_under(r.trace, SPAN), r.steps)
