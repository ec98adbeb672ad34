"""Named spans of the port's work: one timing mechanism for the training
step and the shuffle.

``span(name)`` is a context manager. With no :class:`Recorder` open it is
a shared null context: the cost is one module-level read. Inside an open
recorder each call records two times, each summed over the calls of the
name when the recorder is read:

* *device ms*: CUDA events recorded at enter and exit on the stream
  that was current when the recorder opened (the host clock on the
  CPU);
* *host ms*: ``time.perf_counter_ns`` from enter to exit.

A span's parent is the span named by its dotted prefix (``map`` holds
``map.forward``). :meth:`Recorder.phase` opens a span whose start is the
end of the previous phase, so consecutive phases share their marks.
Nothing synchronises the card until :meth:`Recorder.read`, which waits
once, on the last event recorded.

While a profiler runs, each call also emits a host event
``camr.<name>`` (``torch._C._profiler._RecordFunctionFast``, not a user
annotation), so a trace holds every span on the kernels' clock, as a
host op around the ops it issued. No name starts with ``cu``: trace
readers drop host events named so, as CUDA runtime calls.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Recorder", "current", "span"]

_NULL = contextlib.nullcontext()
_current: Recorder | None = None
#: timing events of recorders already read, recorded again by later ones
#: (creating and destroying two CUDA events a span costs more than the
#: span's own records)
_POOL: list = []


def current() -> Recorder | None:
    """The innermost open recorder, if any."""
    return _current


def span(name: str):
    """A context manager that records one call of ``name`` in the open
    recorder, and does nothing when none is open. Entered, it gives the
    call (its times are set when the recorder is read), or None."""
    rec = _current
    return _NULL if rec is None else _Call(rec, name)


class _Call:
    """One call of a span: its two marks, then its times once read."""

    __slots__ = ("rec", "name", "phase", "start", "end", "fn",
                 "device_ms", "host_ms")

    def __init__(self, rec: Recorder, name: str, phase: bool = False):
        self.rec, self.name, self.phase = rec, name, phase
        self.start = self.end = self.fn = None
        self.device_ms = self.host_ms = None

    def __enter__(self) -> _Call:
        if _profiler_enabled():
            self.fn = _RecordFunctionFast("camr." + self.name)
            self.fn.__enter__()
        rec = self.rec
        self.start = (rec._edge if self.phase and rec._edge is not None
                      else rec._mark())
        rec.calls.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.end = self.rec._mark()
        if self.phase:
            self.rec._edge = self.end
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


class Recorder:
    """The spans of one unit of work (a training step, or a shuffle timed
    alone). ``with Recorder(device):`` opens it: spans entered inside
    record into it, and into no recorder it encloses. Read it once, after
    it is closed."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        #: the stream the events are recorded on: current at the opening
        self._stream = torch.cuda.current_stream(device) if self.cuda else None
        self.calls: list[_Call] = []
        self._events: list = []        # every event recorded, in order
        self._edge = None              # the last phase's end mark
        self._after: list = []
        self._prev = None

    def __enter__(self) -> Recorder:
        global _current
        self._prev, _current = _current, self
        return self

    def __exit__(self, *exc) -> bool:
        global _current
        _current, self._prev = self._prev, None
        return False

    def phase(self, name: str) -> _Call:
        """A span that starts where the previous phase ended."""
        return _Call(self, name, phase=True)

    def after_read(self, fn) -> None:
        """Call ``fn()`` once the recorder has been read (the calls' times
        are set then)."""
        self._after.append(fn)

    def _mark(self):
        ev = None
        if self.cuda:
            ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._events.append(ev)
        return ev, time.perf_counter_ns()

    def read(self) -> dict:
        """``{name: (device ms, host ms)}``, each summed over the calls of
        the name; the first call to read waits for the card once, on the
        last event recorded, and then hands the events on for reuse."""
        if self._events:
            self._events[-1].synchronize()
        out: dict = {}
        for c in self.calls:
            if c.device_ms is None:
                (e0, t0), (e1, t1) = c.start, c.end
                c.host_ms = (t1 - t0) / 1e6
                c.device_ms = e0.elapsed_time(e1) if self.cuda else c.host_ms
            dev, host = out.get(c.name, (0.0, 0.0))
            out[c.name] = (dev + c.device_ms, host + c.host_ms)
        _POOL.extend(self._events)
        self._events = []
        after, self._after = self._after, []
        for fn in after:
            fn()
        return out
