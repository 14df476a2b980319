"""Hierarchical timing, call counters and profiler hooks.

Counterpart of ``src/Utilities/Timer_Utils.f90`` +
``src/Utilities/Timer.fypp``: atomic timers with elapsed/min/max/count and
pause/resume (Timer_Utils.f90:12-74), timer groups (:77-86), a registry
"watch" with private + user timers (:89-158), and a global enable flag
``time_lightkrylov()`` guarding all instrumentation (Timer.fypp:24,45-47).

On an accelerator, wall-clock timing of jitted code requires ``block_until_ready``
synchronisation; timers therefore only synchronise when enabled, so the
instrumentation is free when switched off (same contract as the reference).
``jax.profiler`` trace annotations are emitted alongside so device traces
show the solver stages.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

from . import logger as _logger

__all__ = [
    "Timer",
    "Watch",
    "global_watch",
    "time_lightkrylov",
    "set_timing",
    "timed",
    "timed_fn",
    "matvec_counter",
    "operator_label",
    "count_applications",
    "reset_counters",
    "get_counter",
    "counters_summary",
]

_timing_enabled = False


def time_lightkrylov() -> bool:
    """Global instrumentation flag (reference: Timer.fypp:24,45-47)."""
    return _timing_enabled


def set_timing(enabled: bool) -> None:
    global _timing_enabled
    _timing_enabled = enabled


@dataclass
class Timer:
    """Atomic named timer (reference: ``lightkrylov_timer``,
    Timer_Utils.f90:12-74)."""

    name: str
    etime: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    count: int = 0
    running: bool = False
    _t0: float = 0.0
    history: list = field(default_factory=list)

    def start(self):
        if not self.running:
            self.running = True
            self._t0 = time.perf_counter()

    def stop(self):
        if self.running:
            dt = time.perf_counter() - self._t0
            self.etime += dt
            self.tmin = min(self.tmin, dt)
            self.tmax = max(self.tmax, dt)
            self.count += 1
            self.running = False

    def pause(self):
        if self.running:
            self.etime += time.perf_counter() - self._t0
            self.running = False

    def reset(self, soft: bool = True):
        """Soft reset archives current stats to history; hard reset wipes
        (reference: soft/hard reset, Timer_Utils.f90:221-419)."""
        if soft and self.count:
            self.history.append((self.etime, self.tmin, self.tmax, self.count))
        self.etime, self.tmin, self.tmax, self.count = 0.0, float("inf"), 0.0, 0
        self.running = False
        if not soft:
            self.history.clear()

    @property
    def avg(self) -> float:
        return self.etime / self.count if self.count else 0.0


class Watch:
    """Timer registry with groups (reference: ``abstract_watch`` +
    ``lightkrylov_watch``, Timer_Utils.f90:89-158, Timer.fypp:67-113)."""

    def __init__(self, name: str = "lightkrylov_watch"):
        self.name = name
        self._timers: dict[str, Timer] = {}
        self._groups: dict[str, list[str]] = defaultdict(list)

    def add_timer(self, name: str, group: str = "user") -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
            self._groups[group].append(name)
        return self._timers[name]

    def remove_timer(self, name: str) -> None:
        self._timers.pop(name, None)
        for names in self._groups.values():
            if name in names:
                names.remove(name)

    def timer(self, name: str) -> Timer:
        return self.add_timer(name)

    def reset_all(self, soft: bool = True) -> None:
        for t in self._timers.values():
            t.reset(soft=soft)

    def summary(self) -> str:
        """Grouped min/avg/max/count report
        (reference: ``print_timer_summary``, Timer_Utils.f90:221-419)."""
        lines = [f"== {self.name} timing summary =="]
        for group, names in self._groups.items():
            active = [self._timers[n] for n in names if n in self._timers and self._timers[n].count]
            if not active:
                continue
            lines.append(f"-- {group} --")
            for t in active:
                lines.append(
                    f"  {t.name:<40s} n={t.count:<6d} total={t.etime:.4e}s "
                    f"min={t.tmin:.4e}s avg={t.avg:.4e}s max={t.tmax:.4e}s"
                )
        return "\n".join(lines)

    def print_summary(self) -> None:
        _logger.log_message(self.summary())


#: Global watch, mirroring ``global_lightkrylov_timer`` (Timer.fypp:30-41).
global_watch = Watch()


def timed_fn(name: str, group: str = "user"):
    """Decorator bracketing an eager library routine with a named timer,
    synchronising on the routine's outputs so device work is attributed to
    it (reference: every routine self-times when ``time_lightkrylov()`` is
    on — Timer.fypp:67-113, arnoldi.fypp:18,75).  Zero overhead when timing
    is disabled."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # Skip instrumentation entirely inside a jit/scan trace: wall
            # clocks are meaningless there and block_until_ready on tracers
            # is not (timers bracket *eager* routine calls, like the
            # reference's start/stop pairs around each library routine).
            if not _timing_enabled or _tracing():
                return fn(*args, **kwargs)
            with timed(name, group):
                out = fn(*args, **kwargs)
                try:
                    jax.block_until_ready(out)
                except Exception:  # non-array outputs: wall-clock only
                    pass
            return out
        return wrapper
    return deco


@contextmanager
def timed(name: str, group: str = "user"):
    """Context manager bracketing a stage with a named timer + profiler
    annotation (reference: the ``timer%start/stop`` brackets wrapping every
    library routine, e.g. arnoldi.fypp:18,75)."""
    if not _timing_enabled:
        yield
        return
    t = global_watch.add_timer(name, group)
    with jax.profiler.TraceAnnotation(name):
        t.start()
        try:
            yield
        finally:
            t.stop()


# -- call counters -----------------------------------------------------------
#
# The reference counts every matvec/rmatvec/response on the operator instance
# (AbstractLinops.fypp:34-37,391-424).  Instances here are immutable pytrees,
# so counters live in a host-side registry.  Eager applications increment
# directly; traced (jitted) applications go through io_callback so *executed*
# applications are counted.  ``set_callback_counting(False)`` switches to
# trace-time counting (one count per compiled trace) for runtimes without
# host-callback support.

_counters: dict[str, int] = defaultdict(int)
_callback_counting = True

# Per-instance naming (reference counts per-instance on the operator object,
# AbstractLinops.fypp:34-37): the first instance of a class counted keeps the
# bare class name; further live instances get a ``#n`` suffix, so two
# DenseOperators (e.g. A and a dense preconditioner M) no longer merge their
# counts.  An explicit ``A.label = "..."`` attribute overrides the generated
# name.  Entries are keyed by ``id`` with a weakref finalizer so collected
# operators free their slot.
_instance_names: dict[int, str] = {}
_class_counts: dict[str, int] = defaultdict(int)


def operator_label(A) -> str:
    """Stable per-instance counter key for operator ``A``."""
    import weakref

    lbl = getattr(A, "label", None)
    if lbl:
        return str(lbl)
    if getattr(A, "_aslinop_wrapped", False):
        # anonymous wrapper minted by aslinop() inside a solver call: key by
        # bare class name so repeated solves with the same raw matrix or
        # callable aggregate instead of fragmenting across #n suffixes
        return type(A).__name__
    key = id(A)
    name = _instance_names.get(key)
    if name is None:
        base = type(A).__name__
        seq = _class_counts[base]
        _class_counts[base] += 1
        name = base if seq == 0 else f"{base}#{seq}"
        _instance_names[key] = name

        def _drop(key=key, name=name):
            # only drop if the slot still belongs to this instance (ids are
            # reused after GC, and reset_counters may have re-assigned it)
            if _instance_names.get(key) == name:
                _instance_names.pop(key, None)

        try:
            weakref.finalize(A, _drop)
        except TypeError:  # non-weakref-able object: entry persists
            pass
    return name


def set_callback_counting(enabled: bool) -> None:
    """Disable io_callback-based counting on runtimes that lack host
    callbacks; counters then record trace events, not executions."""
    global _callback_counting
    _callback_counting = enabled


def _tracing() -> bool:
    """True when called during a jit/scan trace (ops return Tracers)."""
    import jax.numpy as jnp

    return isinstance(jnp.add(0, 0), jax.core.Tracer)


def _bump(name: str):
    def cb(_):
        _counters[name] += 1

    if not _tracing():
        _counters[name] += 1  # eager: count directly
    elif _callback_counting:
        jax.experimental.io_callback(cb, None, 0, ordered=False)
    else:
        _counters[name] += 1  # trace-time count (once per compilation)


def matvec_counter(A, name: str):
    """Wrap operator ``A`` so each matvec/rmatvec bumps a named host counter
    (reference: ``apply_matvec`` counting wrapper,
    AbstractLinops.fypp:391-424)."""
    from ..linops import MatvecOperator

    def mv(x):
        _bump(name + ".matvec")
        return A.matvec(x)

    def rmv(y):
        _bump(name + ".rmatvec")
        return A.rmatvec(y)

    return MatvecOperator(mv, rmv, is_hermitian=A.is_hermitian)


def count_applications(A, n: int, kind: str = "matvec") -> None:
    """Record that operator ``A`` was applied ``n`` times.

    This realizes the reference's per-operator ``apply_matvec`` counting
    wrappers (AbstractLinops.fypp:34-37,390-424): solver cores are single
    jitted ``while_loop``s, and per-application host callbacks would
    serialize the device stream.  Instead every
    solver *knows* how many applications its jitted sweep executed (from
    its returned iteration counts) and records them here eagerly — counts
    are execution-accurate, keyed per operator *instance* (first instance
    of a class keeps the bare class name; set ``A.label`` to override)."""
    if n:
        _counters[f"{operator_label(A)}.{kind}"] += int(n)


def reset_counters() -> None:
    """Clear all counters AND the per-instance naming epoch, so the first
    instance of each class counted after a reset gets the bare class name
    again (mirrors the reference's hard timer reset)."""
    _counters.clear()
    _instance_names.clear()
    _class_counts.clear()


def get_counter(name: str) -> int:
    return _counters[name]


def counters_summary() -> str:
    """Formatted table of all nonzero call counters (reference: the
    matvec/rmatvec counts printed by the operator finalizers)."""
    lines = ["== call counters =="]
    for name in sorted(_counters):
        lines.append(f"  {name:<40s} {_counters[name]}")
    return "\n".join(lines)
