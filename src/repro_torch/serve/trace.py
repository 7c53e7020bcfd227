"""The port's span recorder: where the serving engine and ``compile_model``
spend their time, from inside the program.

``span(name, rid=None, **attrs)`` is a context manager.  It records the
name, its start and end on ``time.perf_counter()``, the index of the span
open around it (its parent), the request id and its attributes, and the
delta of ``kernels.bsr_matmul.LAUNCHES["bsr_matmul"]`` (kernel 1's
launches) over its extent: the launch count of an admission is the delta
on its span, and a graph replay's launches, which the engine adds to
``LAUNCHES`` itself, reach the span around the replay.  ``begin`` opens a
span that nests nothing and ends at its ``end()`` (a request's wait in the
queue, from ``submit`` to its admission).

Spans are kept, oldest dropped first, in a ring of ``CAPACITY`` entries;
``spans()`` returns what it holds and how many it dropped.  A span enters
the ring when it opens, so the ring is in order of start, and a span still
open has ``t1`` None.  A closed span is held as a flat tuple of plain
values (its attributes' names and values as two more), which the garbage
collector stops tracking: a ring of tracked objects would have each full
collection walk all of it, which costs more than the span.
Recording is on by default; ``enable(False)`` makes ``span``, ``begin``
and ``tally`` no-ops.

``tally(device)`` opens a ``Tally`` of the MoE dispatches that run inside
its block (the engine opens one around each eager admission's prefill):
``models.moe`` adds the (token, expert) pairs it routes, counted on the
host, and those its capacity rule keeps, counted on the device, so that
the caller reads the count with a copy it makes anyway.

While a ``torch.profiler`` is active, each span also opens a host range
``repro.<name>`` in the profiler's trace, on the clock of the device's
events, so a profiled slice can name each idle gap by the span open at the
time.  The range is a plain host operation, not a user annotation: a
``record_function`` annotation would also put a range of the same name on
the device's timeline, which a trace reader would count as device work.

One thread drives the engine; the recorder takes no lock.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from repro_torch.kernels import bsr_matmul as K

CAPACITY = 1 << 17
PREFIX = "repro."

enabled = True
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_count = 0          # spans ever opened; the next span's index
_epoch = 0          # advanced by ``reset``
_open: list = []    # the nested spans open now, innermost last
_tally = None       # the ``Tally`` open now, if any


class Span:
    """One span.  ``t1`` and ``launches`` are None while it is open."""

    __slots__ = ("index", "name", "rid", "attrs", "parent", "t0", "t1",
                 "launches", "_l0", "_range", "_nested", "_epoch")

    def __init__(self, name, rid, attrs, nested):
        global _count
        self.index, self.name, self.rid, self.attrs = _count, name, rid, attrs
        _count += 1
        self.parent = _open[-1].index if _open else None
        self._nested, self._epoch = nested, _epoch
        self.t1 = self.launches = self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + name)
            self._range.__enter__()
        _ring.append(self)
        if nested:
            _open.append(self)
        self._l0 = K.LAUNCHES["bsr_matmul"]
        self.t0 = time.perf_counter()

    def end(self):
        self.t1 = time.perf_counter()
        self.launches = K.LAUNCHES["bsr_matmul"] - self._l0
        if self._nested and _open and _open[-1] is self:
            _open.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        at = self.index - (_count - len(_ring))     # its place, if held
        if self._epoch == _epoch and at >= 0:
            _ring[at] = (self.index, self.name, self.rid, tuple(self.attrs),
                         tuple(self.attrs.values()), self.parent, self.t0,
                         self.t1, self.launches)

    @classmethod
    def _held(cls, entry):
        """The span of a ring entry (a closed span's tuple)."""
        if not isinstance(entry, tuple):
            return entry
        sp = object.__new__(cls)
        (sp.index, sp.name, sp.rid, keys, values, sp.parent, sp.t0, sp.t1,
         sp.launches) = entry
        sp.attrs = dict(zip(keys, values))
        return sp

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    @property
    def ms(self):
        return (self.t1 - self.t0) * 1e3

    def __repr__(self):
        return (f"Span({self.index} {self.name!r} parent={self.parent} "
                f"rid={self.rid} t0={self.t0} t1={self.t1} "
                f"launches={self.launches} {self.attrs})")


class _Off:
    """What ``span`` returns while recording is off: binds None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, rid=None, **attrs):
    """A span over a ``with`` block; binds the ``Span`` (None while
    recording is off), whose ``attrs`` the block may add to."""
    if not enabled:
        return _OFF
    return Span(name, rid, attrs, True)


def begin(name, rid=None, **attrs):
    """A span opened now and ended by its ``end()``, nesting nothing
    (None while recording is off)."""
    if not enabled:
        return None
    return Span(name, rid, attrs, False)


class Tally:
    """The MoE dispatches inside a ``tally`` block: ``pairs`` routed
    (token, expert) pairs (a host int) and ``kept`` those within their
    expert's capacity (a 0-dim int64 tensor on ``device``)."""

    __slots__ = ("pairs", "kept")

    def __init__(self, device):
        self.pairs = 0
        self.kept = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, pairs, kept):
        self.pairs += pairs
        self.kept.add_(kept)


@contextlib.contextmanager
def tally(device):
    """A ``Tally`` the MoE dispatches inside the block add to (None, and
    no tally, while recording is off)."""
    global _tally
    if not enabled:
        yield None
        return
    _tally = t = Tally(device)
    try:
        yield t
    finally:
        _tally = None


def open_tally():
    """The ``Tally`` open now, or None."""
    return _tally


def note_memory(sp, device):
    """Give ``sp`` the card's ``memory_allocated`` now (nothing off the
    card or while recording is off)."""
    if sp is not None and device.type == "cuda":
        sp.attrs["memory_allocated"] = torch.cuda.memory_allocated(device)


def enable(on=True):
    global enabled
    enabled = bool(on)


def spans():
    """(the spans held, oldest first; how many were dropped)."""
    return [Span._held(e) for e in _ring], _count - len(_ring)


def reset(capacity=CAPACITY):
    """Forget every span; the ring holds ``capacity`` from now on."""
    global _ring, _count, _epoch
    _ring = collections.deque(maxlen=capacity)
    _count = 0
    _epoch += 1
    _open.clear()
