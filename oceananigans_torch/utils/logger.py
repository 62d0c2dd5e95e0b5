"""Timestamped, colored logging (reference ``src/Logger.jl:19-45``); a copy
of ``oceananigans_tpu/utils/logger.py``."""

from __future__ import annotations

import logging
import sys
import time

__all__ = ["OceananigansLogger", "get_logger"]

_COLORS = {
    logging.DEBUG: "\x1b[36m",      # cyan
    logging.INFO: "\x1b[32m",       # green
    logging.WARNING: "\x1b[33m",    # yellow
    logging.ERROR: "\x1b[31m",      # red
    logging.CRITICAL: "\x1b[35m",   # magenta
}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def __init__(self, color=True):
        super().__init__()
        self.color = color
        self.t0 = time.time()

    def format(self, record):
        dt = time.time() - self.t0
        lvl = record.levelname.lower()
        if self.color and record.levelno in _COLORS:
            lvl = f"{_COLORS[record.levelno]}{lvl}{_RESET}"
        return (f"[ {dt:10.3f}s ] {lvl}: {record.getMessage()} "
                f"({record.module}:{record.lineno})")


def OceananigansLogger(level=logging.INFO, stream=None, color=None):
    """Build the standard handler (install with ``get_logger``)."""
    stream = stream or sys.stderr
    if color is None:
        color = hasattr(stream, "isatty") and stream.isatty()
    h = logging.StreamHandler(stream)
    h.setFormatter(_Formatter(color=color))
    h.setLevel(level)
    return h


def get_logger(name="oceananigans_torch", level=logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.addHandler(OceananigansLogger(level))
        logger.setLevel(level)
    return logger
