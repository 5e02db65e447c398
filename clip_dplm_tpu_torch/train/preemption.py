"""Preemption-safe training: save the live train state on SIGTERM.

Counterpart of `clip_dplm_tpu/train/preemption.py`. A preemptible machine
gets SIGTERM shortly before it is taken away; catching it and saving at the
step, not at the last epoch's best, is what lets a run resume where it
stopped.

The signal handler only sets a flag (async-signal-safe; no file is written
inside a handler). The Trainer polls the flag after every step: a host read
of a `threading.Event`, which never waits on the device, so the host keeps
its run-ahead of the card. When the flag is set, the Trainer makes one save
of the live state and ends its loop (train/trainer.py).
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class PreemptionGuard:
    """Latches termination signals into a thread-safe flag.

    Use as a context manager (or call install()/uninstall()) around a train
    loop; poll `requested` between steps. `request()` sets the flag from
    code (tests, watchdogs). The handler chains to a handler installed
    before it, if that one is callable, so an outer framework still sees
    the signal; uninstall restores the previous dispositions.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        self._event.set()

    def requested_globally(self) -> bool:
        """The flag as every process of the job agrees on it. The port runs
        one process, so this is the local flag; agreement across processes
        (an all-gather of the flags at a step every process reaches) comes
        with multi-GPU training (ROADMAP queue 1 item 13)."""
        return self.requested

    def _handler(self, signum, frame) -> None:
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        """Register the handlers. Only the main thread may (a CPython rule);
        elsewhere this does nothing and `request()` is the way in."""
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):  # not the main thread, or an exotic prev
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> Optional[bool]:
        self.uninstall()
        return None
