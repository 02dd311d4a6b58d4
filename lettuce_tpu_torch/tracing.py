"""Host tracing of lettuce_tpu_torch: spans at its layer boundaries, and
one counter of kernel launches and library events.

Tracing is off unless a caller records::

    from lettuce_tpu_torch import tracing

    with tracing.recording() as record:
        segment(f).sum().backward()
    record.spans    # [(name, parent, start_ns, end_ns), ...]
    record.counts   # what was counted while recording
    tracing.summary(record.spans)  # {name: (calls, total_ns, self_ns)}

Off, a span site costs one test: :func:`span` returns one shared null
context, reads no clock and opens no profiler label. On, each span the
recording closes is a row ``(name, parent, start_ns, end_ns)``
(``time.perf_counter_ns``) of ``record.spans``; ``parent`` is the index of
the span that encloses it on the same thread, None at a thread's top
(autograd runs a CUDA backward on a thread of its own). While a
``torch.profiler`` session runs, a span also opens the label
``lt:<name>``, so the profiler's trace shows it beside the kernels. A
span's self time (:func:`self_times`) is its duration less its
children's.

The spans, one per layer boundary:

* ``step``: one differentiable step (``fused_step``,
  ``fused_multi_step``): the Function's apply and the outlet replay;
* ``replay``: the outlets' window replay of one step (``hybrid_outlets``);
* ``launch``: a wrapper's CUDA branch, from its entry to the C entry's
  return: the checks and the launch plan, then ``enqueue``;
* ``enqueue``: the ctypes call into the C entry, inside ``launch``;
* ``adjoint``: a step's backward (``_FusedStep``, ``_FusedMultiStep``),
  its adjoint launch included;
* ``vjp``: split mode's VJP of the pointwise pre-streaming map
  (``adjoint.prestream_vjp``: the map's recompute and its
  ``autograd.grad``), inside ``adjoint`` on autograd's thread;
* ``load``: ``build.open_library``: hashing the sources, any ``nvcc``
  build, loading the library.

The counter :data:`counts` is always on, recording or not: every kernel
launch counts under :func:`launch_key` (``K1`` the single-step forward,
``K2`` the blocked forward, ``K3`` the adjoint, ``K4`` the blocked
adjoint, ``K5`` the velocity moment of ``Flow.u`` and its adjoint),
``moments_torch`` every ``Flow.u`` of a CUDA state that runs the torch
expression instead of K5, ``vjp:<fragment>`` every split-mode VJP (once a
step, a 16-bit state too), ``replay`` every replay, ``library_built``
every ``nvcc`` run and ``library_opened`` every library loaded. K5's
launches open no span: the counts say how often ``Flow.u`` takes it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter

import torch

__all__ = ["counts", "count", "launch_key", "span", "recording", "Record",
           "self_times", "summary"]

# every launch and library event since the process started
counts = Counter()

_record = None  # the Record of the running recording(); None: tracing off
_profiler = torch.autograd.profiler  # ._is_profiler_enabled: a session runs
_numbers = itertools.count()  # spans in the order they open, all threads


class _Thread(threading.local):
    """``top``: this thread's innermost open span (None: none is open)."""

    top = None


_thread = _Thread()


class _Null:
    """The context of every span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Record:
    """What one :func:`recording` traced: ``spans`` and ``counts``."""

    def __init__(self):
        # (name, parent's number, number, start_ns, end_ns) of each closed
        # span: tuples of numbers and strings, which the garbage collector
        # stops tracking
        self._closed = []
        self.counts = Counter()

    @property
    def spans(self) -> list:
        """``[(name, parent, start_ns, end_ns)]`` of the closed spans in
        the order they opened; ``parent`` indexes this list (a parent
        opens before its children) or is None."""
        rows = sorted(self._closed, key=lambda row: row[2])
        index = {row[2]: i for i, row in enumerate(rows)}
        return [(name, index.get(parent), start, end)
                for name, parent, _, start, end in rows]


class _Span:
    """One open span; closing it appends its row to the record."""

    __slots__ = ("name", "closed", "parent", "number", "start", "label")

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.label = torch.profiler.record_function("lt:" + self.name)
            self.label.__enter__()
        else:
            self.label = None
        thread = _thread
        self.parent = thread.top
        thread.top = self
        self.number = next(_numbers)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        parent = self.parent
        self.closed.append((self.name,
                            None if parent is None else parent.number,
                            self.number, self.start, end))
        _thread.top = parent
        if self.label is not None:
            self.label.__exit__(*exc)
        return False


def span(name: str):
    """The context of one span ``name``: recorded while a
    :func:`recording` runs, else the shared null context."""
    record = _record
    if record is None:
        return _NULL
    entry = _Span()
    entry.name, entry.closed = name, record._closed
    return entry


@contextlib.contextmanager
def recording():
    """Switch tracing on for the ``with`` block and yield its
    :class:`Record`; the tracing of an enclosing recording resumes after
    it."""
    global _record
    outer, record = _record, Record()
    _record = record
    try:
        yield record
    finally:
        _record = outer


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``key`` in :data:`counts` (and in the running
    recording's)."""
    counts[key] += n
    record = _record
    if record is not None:
        record.counts[key] += n


def launch_key(kernel: str, variant: str, fragment: str, storage: str,
               n_sub: int = None) -> str:
    """The counter key of a launch of ``kernel`` (``K1``..``K5``):
    ``<kernel>:<variant><fragment>_<storage>``, and ``_x<n_sub>`` for a
    blocked one; ``variant`` is empty or ends in ``_`` (``masked_``,
    ``emit_u_``, ``masked_emit_u_``, ``frozen_``, ``adjoint_``),
    ``storage`` is :func:`.ops.cuda.build.storage_suffix`'s; K5's
    ``fragment`` is ``u``, the moment it computes. So
    ``K1:masked_emit_u_bgk_f32``, ``K1:trt_bf16_dev``,
    ``K2:masked_bgk_f32_x2``, ``K4:bgk_bf16_x2``, ``K5:u_f32``,
    ``K5:adjoint_u_bf16``."""
    key = f"{kernel}:{variant}{fragment}_{storage}"
    return key if n_sub is None else f"{key}_x{n_sub}"


def self_times(spans) -> list:
    """Each span's duration less its children's, in ns (the children of
    a span run on its thread, one after another, inside it)."""
    own = [end - start for _, _, start, end in spans]
    for _, parent, start, end in spans:
        if parent is not None:
            own[parent] -= end - start
    return own


def summary(spans) -> dict:
    """``{name: (calls, total_ns, self_ns)}`` over closed ``spans``."""
    out = {}
    for (name, _, start, end), own in zip(spans, self_times(spans)):
        calls, total, self_ns = out.get(name, (0, 0, 0))
        out[name] = (calls + 1, total + end - start, self_ns + own)
    return out
