"""Named ranges inside the port, for the ``torch.profiler`` an operator
starts.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler is collecting and one shared no-op context otherwise: a bare
``record_function`` costs about 14 us a call with no profiler, the check
under 1 us.  The ranges land in the profiler's Chrome trace as
``user_annotation`` events on the clock of the kernels and copies, and
every launch inside one carries a correlation id that ties its device
work to it.  Names are ``ft:<layer>.<part>``, one to a site, with no
layer index.  There is no switch: the profiler is the only consumer.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd.profiler import record_function

_OFF = nullcontext()
_collecting = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks ``name`` in a collecting profiler's trace."""
    return record_function(name) if _collecting() else _OFF
