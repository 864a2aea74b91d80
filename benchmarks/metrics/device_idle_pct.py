"""The share of the traced window in which no kernel ran on the device."""

from harness.readers import device_idle_pct


def read(r):
    return device_idle_pct(r)
