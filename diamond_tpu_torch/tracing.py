"""Program spans on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch profiler
records (the benchmark's traced window, the trainer's ``tpu.profile_dir`` epoch), and a
shared no-op context after one flag check otherwise: an idle ``record_function`` costs
~10 us of host time a call, the check ~0.05 us. The profiler keeps the ranges with its
trace, so the device time and the idle gaps of a trace can be put down to the span the
host was in when it launched each kernel.

The spans sit at the port's layer boundaries: the IC pool (``pool::ensure``,
``pool::build``, ``pool::wait``), the imagination rollout (``ac::rollout`` and inside
it ``wm::transition``, ``ac::policy``, ``ac::reset``), the loss (``ac::loss``), the
train steps (``train::backward``, ``train::update``) and the trainer's parts
(``trainer::<part>``). Two spans of one name never nest, so a kernel is counted once
under a name.

A profiler records the threads it was started on; ``all_threads()`` is the experimental
option that records every thread (the IC pool's build thread), where torch has it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a torch profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str) -> Callable:
    """A method or function whose every call is one ``span(name)``, inside it (so that
    a wrapper set on an instance still sees the span)."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def all_threads() -> Optional[object]:
    """The profiler's experimental config that records every thread, or None where the
    installed torch lacks the option."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None
