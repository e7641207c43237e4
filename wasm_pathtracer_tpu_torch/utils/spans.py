"""Host spans at the port's layer boundaries, on the profiler's clock.

``with span("queue.iter"):`` records a host event ``wpt/queue.iter``
while a ``torch.profiler.profile`` session is active, so the span lands
in the profiler's own event buffer, on the same timeline as the device
operations it traced.  With no profiler running it enters nothing and
costs one module-flag read: no host read, no synchronisation and no
device operation either way.

The event is the profiler's plain host-op record (``_RecordFunctionFast``),
not ``torch.profiler.record_function``: that one opens a user annotation,
which the profiler mirrors onto the device timeline as a range over every
kernel launched inside it, so a device trace would read the card busy
wherever a span was open.

``args`` (a dict of names to ints or strings) carries the identifier of
a batch or step; the trace shows it where the profiler records shapes.
Span names stay constant.
"""

from __future__ import annotations

from contextlib import nullcontext

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "wpt/"
_OFF = nullcontext()


def span(name: str, args: dict | None = None):
    """A context manager: the profiler's host event ``"wpt/" + name``
    inside a profile, a shared no-op outside one."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _RecordFunctionFast(PREFIX + name)
    return _RecordFunctionFast(PREFIX + name, (), args)
