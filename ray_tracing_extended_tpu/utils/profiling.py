"""Tracing / profiling hooks (SURVEY.md section 5: absent in the reference;
first-class here).

``trace(logdir)`` wraps a code region in a jax.profiler trace (xplane dump
for xprof/tensorboard); ``debug_mode()`` enables the framework's "sanitizer"
analog - NaN checking on every jitted computation (the functional-JAX
equivalent of a race/memory sanitizer: the only failure class reachable in
pure data-parallel code is numeric poison).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: ``with profiling.trace('/tmp/xplane'): render()``.

    View with xprof / tensorboard.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """NaN sanitizer + optional op-by-op execution for kernel debugging.

    The bounce loop is NaN-free by construction (dead lanes keep a
    tiny-clamped roulette denominator, ops/trace.py), so any NaN this
    reports is a real defect."""
    ctxs = []
    if nans:
        ctxs.append(jax.debug_nans(True))
    if disable_jit:
        ctxs.append(jax.disable_jit())
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        yield


def program_bytes(jitted, *args, **kwargs) -> int | None:
    """Device bytes one call of ``jitted`` with these arguments holds:
    arguments, outputs and temporaries of its compiled program (donated
    buffers counted once), from XLA's memory analysis. Unlike the process's
    ``peak_bytes_in_use`` it belongs to this program alone. None where the
    backend does not report it."""
    m = jitted.lower(*args, **kwargs).compile().memory_analysis()
    if m is None:
        return None
    return int(
        m.argument_size_in_bytes + m.output_size_in_bytes
        + m.temp_size_in_bytes - m.alias_size_in_bytes
    )


def annotate(name: str):
    """Named profiler span for driver-side phases."""
    return jax.profiler.TraceAnnotation(name)
