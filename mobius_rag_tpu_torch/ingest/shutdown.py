"""SIGTERM-aware graceful shutdown (reference: app/worker/shutdown.py:
51-118): handlers set a flag; worker loops check it between jobs and
finish the in-flight job before exiting.

Ported from ``mobius_rag_tpu.ingest.shutdown`` with the port's imports.
"""
from __future__ import annotations

import signal
import threading
import time

_flag = threading.Event()


def install_handlers() -> None:
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: _flag.set())
        except ValueError:
            pass  # not the main thread — rely on request_shutdown()


def request_shutdown() -> None:
    _flag.set()


def reset() -> None:
    _flag.clear()


def is_shutting_down() -> bool:
    return _flag.is_set()


def sleep_or_shutdown(seconds: float) -> bool:
    """Sleep up to `seconds`, waking early on shutdown. Returns True when
    shutting down."""
    return _flag.wait(timeout=seconds)


def wait_until(predicate, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline and not _flag.is_set():
        if predicate():
            return True
        time.sleep(poll_s)
    return predicate()
