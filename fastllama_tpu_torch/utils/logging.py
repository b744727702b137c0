"""Logging + console colors + timing.

Port of ``fastllama_tpu/utils/logging.py``: the C++ engine's printf
macros with func/file/line prefixes, ANSI colors and its microsecond
``Timer``.
"""
from __future__ import annotations

import logging
import sys
import time

_logger = logging.getLogger("fastllama_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "[%(levelname).1s %(asctime)s %(module)s:%(lineno)d] %(message)s",
        datefmt="%H:%M:%S"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)

log_debug = _logger.debug
log_info = _logger.info
log_error = _logger.error


def set_debug(on: bool = True) -> None:
    _logger.setLevel(logging.DEBUG if on else logging.INFO)


class Console:
    """ANSI color helper (console.h:18-49); disabled when not a tty."""

    def __init__(self, enabled=None):
        self.enabled = sys.stdout.isatty() if enabled is None else enabled

    def _c(self, code: str) -> str:
        return f"\x1b[{code}m" if self.enabled else ""

    def yellow(self) -> str:
        return self._c("33")

    def green(self) -> str:
        return self._c("32")

    def red(self) -> str:
        return self._c("31")

    def end(self) -> str:
        return self._c("0")


class Timer:
    """Microsecond wall-clock timer (utility.h:68-89)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3
