"""The state a ``dsc.compile`` program (fuse.py) sets while it runs ``fn``.

A program runs the user's function in one of two modes:

- ``'trace'``: the first run of a signature. Creation ops (``from_numpy``,
  ``randn``, ``full``, ...) run and their results are kept as the
  program's constants;
- ``'replay'``: every later run (the capture of a CUDA graph, or a re-run
  on the CPU). A creation op returns a copy of the constant the trace run
  kept in its place, so the values are the same on every call, as the JAX
  package bakes them into its program (dsc_tpu/fuse.py:28-30); the copy is
  a device-to-device copy, which a CUDA graph can capture where an upload
  from the host cannot.

In both modes a concrete read (``Tensor.numpy()``, the 1-element unwrap of
``__getitem__``) raises, as a JAX tracer does, and the tensors ``fn``
creates are not counted against the context's memory cap: only the outputs
a program returns to its caller are (``untracked``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch

_state = threading.local()


class Program:
    """The constants and mode of one compiled program's run."""

    def __init__(self, name: str):
        self.name = name
        self.mode = 'trace'
        self.constants: List = []
        self._next = 0

    def constant(self, make: Callable):
        """``make()`` in the trace run, a copy of it kept; in a replay a
        copy of the kept value, in creation order."""
        if self.mode == 'trace':
            t = make()
            # kept apart from what fn gets, which fn may write into
            self.constants.append(t._copy())
            return t
        if self._next >= len(self.constants):
            raise RuntimeError(
                f'dsc.compile({self.name}): the function created more tensors than '
                'in its trace run; its creation ops must not depend on values')
        kept = self.constants[self._next]
        self._next += 1
        return kept._copy()

    def replaying(self) -> None:
        self.mode = 'replay'
        self._next = 0


def current() -> Optional[Program]:
    """The program whose function is running on this thread, if any."""
    return getattr(_state, 'program', None)


@contextmanager
def running(program: Optional[Program]):
    """Run a block as ``program``'s function (None: as eager code), with
    the tensors it creates untracked when a program runs."""
    prev = current()
    prev_untracked = untracked()
    _state.program = program
    _state.untracked = program is not None or prev_untracked
    try:
        yield
    finally:
        _state.program = prev
        _state.untracked = prev_untracked


@contextmanager
def pseudo():
    """A block whose tensors are pseudo-tensors (dsc.map's shape trace):
    untracked, outside any program."""
    prev, prev_untracked = current(), untracked()
    _state.program, _state.untracked = None, True
    try:
        yield
    finally:
        _state.program, _state.untracked = prev, prev_untracked


def untracked() -> bool:
    """Whether tensor buffers created now skip the memory accounting."""
    return getattr(_state, 'untracked', False)


def created(make: Callable):
    """Run the creation op ``make`` as the current program has it: a
    constant of the program, or plainly outside one."""
    program = current()
    return make() if program is None else program.constant(make)


def check_concrete(what: str) -> None:
    """Raise inside a compiled function, where values are not concrete."""
    program = current()
    if program is not None:
        raise RuntimeError(
            f'dsc.compile({program.name}): {what} needs a concrete value, which a '
            'compiled function does not have (a ConcretizationTypeError in the JAX '
            'package); compute the value on the device and return it')


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()
