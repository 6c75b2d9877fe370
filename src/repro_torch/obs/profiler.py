"""Opt-in ``torch.profiler`` trace capture around a named dispatch.

Port of ``repro.obs.profiler``. Disarmed (the default) this is a single
lock-guarded check per dispatch; armed, the next dispatch whose name
contains the match substring runs under ``torch.profiler.profile`` (CPU
activity, plus CUDA when the card is there), and the capture is exported
as a Chrome trace to ``<log_dir>/<sanitized name>.json``. Arm
programmatically::

    from repro_torch.obs import profiler
    profiler.arm("prof", match="256x256", captures=1)

or through the environment before the process starts::

    REPRO_PROFILE_DIR=prof REPRO_PROFILE_MATCH= python ...

A capture failure (profiler unavailable, a profile already running, an
unwritable directory) never takes the dispatch down: the body always runs
exactly once; a failure disarms the hook and is reported through
``logging`` only. The rule covers the profiler alone: an exception of the
body itself propagates.
"""
from __future__ import annotations

import logging
import os
import re
import threading
from contextlib import contextmanager
from typing import Iterator, Optional

log = logging.getLogger("repro_torch.obs.profiler")

_ENV_DIR = "REPRO_PROFILE_DIR"
_ENV_MATCH = "REPRO_PROFILE_MATCH"
_ENV_CAPTURES = "REPRO_PROFILE_CAPTURES"


def _start_profile():
    """A started ``torch.profiler.profile`` over the CPU and, when there
    is one, the CUDA device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


class TraceCapture:
    """Armable one-(or-N-)shot profiler hook.

    ``_dir`` / ``_match`` / ``_remaining`` / ``_env_checked`` are guarded
    by ``_lock``: ``claim`` races against concurrent dispatch workers and
    must hand the capture to exactly one of them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._match: str = ""
        self._remaining: int = 0
        self._env_checked: bool = False

    def arm(self, log_dir: str, match: str = "", captures: int = 1) -> None:
        with self._lock:
            self._dir = str(log_dir)
            self._match = match
            self._remaining = int(captures)
            self._env_checked = True

    def disarm(self) -> None:
        with self._lock:
            self._dir = None
            self._match = ""
            self._remaining = 0
            self._env_checked = True

    def armed(self) -> bool:
        with self._lock:
            self._check_env_locked()
            return self._remaining > 0 and self._dir is not None

    def _check_env_locked(self) -> None:
        if self._env_checked:
            return
        self._env_checked = True
        d = os.environ.get(_ENV_DIR)
        if d:
            self._dir = d
            self._match = os.environ.get(_ENV_MATCH, "")
            self._remaining = int(os.environ.get(_ENV_CAPTURES, "1"))

    def claim(self, name: str) -> Optional[str]:
        """Atomically claim one capture slot for ``name``; returns the
        trace file's path, or None if disarmed / name doesn't match."""
        with self._lock:
            self._check_env_locked()
            if self._remaining <= 0 or self._dir is None:
                return None
            if self._match and self._match not in name:
                return None
            self._remaining -= 1
            sub = re.sub(r"[^A-Za-z0-9._=-]+", "_", name) or "dispatch"
            return os.path.join(self._dir, sub + ".json")

    @contextmanager
    def capture(self, name: str) -> Iterator[bool]:
        """Run the body, profiling it iff a capture slot was claimed.

        Yields True when profiling is live. Never raises on profiler
        failure; the body always executes exactly once.
        """
        path = self.claim(name)
        if path is None:
            yield False
            return
        prof = None
        try:
            prof = _start_profile()
        except Exception:
            log.warning("profiler capture %r failed to start; disarming",
                        name, exc_info=True)
            self.disarm()
            prof = None
        try:
            yield prof is not None
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(os.path.dirname(path) or ".",
                                exist_ok=True)
                    prof.export_chrome_trace(path)
                    log.info("profiler capture %r written to %s", name,
                             path)
                except Exception:
                    log.warning("profiler capture %r failed to finalize; "
                                "disarming", name, exc_info=True)
                    self.disarm()


#: Process-wide hook the serving stack checks around each named dispatch.
CAPTURE = TraceCapture()

arm = CAPTURE.arm
disarm = CAPTURE.disarm
armed = CAPTURE.armed
capture = CAPTURE.capture
