"""Leveled logging with user callbacks.

Counterpart of libplacebo_tpu/core/log.py (pl_log): leveled message
routing with a user-replaceable callback, colorized stderr helpers,
runtime level updates and stack-trace capture on errors.  User hooks
and the renderer's degradation ladder log through `default_log()`.
"""
from __future__ import annotations

import enum
import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["LogLevel", "Log", "log_create", "default_log"]


class LogLevel(enum.IntEnum):
    """Reference pl_log_level (log.h:29-39)."""
    NONE = 0
    FATAL = 1
    ERR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5
    TRACE = 6


_COLORS = {
    LogLevel.FATAL: "\033[31;1m",
    LogLevel.ERR: "\033[31m",
    LogLevel.WARN: "\033[33m",
    LogLevel.INFO: "\033[32m",
    LogLevel.DEBUG: "\033[34m",
    LogLevel.TRACE: "\033[30;1m",
}
_RESET = "\033[0m"
_PREFIX = {
    LogLevel.FATAL: "fatal", LogLevel.ERR: "error", LogLevel.WARN: "warn",
    LogLevel.INFO: "info", LogLevel.DEBUG: "debug", LogLevel.TRACE: "trace",
}


def log_color(level: LogLevel, msg: str, stream=None):
    """Reference pl_log_color: colorized stderr sink."""
    stream = stream or sys.stderr
    color = _COLORS.get(level, "")
    stream.write(f"{color}{_PREFIX.get(level, '?'):5s}: {msg}{_RESET}\n")


def log_simple(level: LogLevel, msg: str, stream=None):
    """Reference pl_log_simple: plain stderr sink."""
    stream = stream or sys.stderr
    stream.write(f"{_PREFIX.get(level, '?'):5s}: {msg}\n")


class Log:
    """Reference pl_log object (log.h:49-105)."""

    def __init__(self, level: LogLevel = LogLevel.INFO,
                 callback: Optional[Callable] = None,
                 capture_backtraces: bool = True):
        self.level = level
        self.callback = callback or log_color
        self.capture_backtraces = capture_backtraces
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def update_level(self, level: LogLevel):
        """Reference pl_log_level_update (log.h:95)."""
        self.level = level

    def msg(self, level: LogLevel, text: str):
        if level > self.level or level == LogLevel.NONE:
            return
        with self._lock:
            self.callback(level, text)
            if level <= LogLevel.ERR and self.capture_backtraces and \
                    self.level >= LogLevel.DEBUG:
                for line in traceback.format_stack()[:-2]:
                    self.callback(LogLevel.DEBUG, line.rstrip())

    def fatal(self, text: str):
        self.msg(LogLevel.FATAL, text)

    def error(self, text: str):
        self.msg(LogLevel.ERR, text)

    def warn(self, text: str):
        self.msg(LogLevel.WARN, text)

    def info(self, text: str):
        self.msg(LogLevel.INFO, text)

    def debug(self, text: str):
        self.msg(LogLevel.DEBUG, text)

    def trace(self, text: str):
        self.msg(LogLevel.TRACE, text)

    def source_dump(self, label: str, source: str):
        """Numbered source dump for failed pipelines (reference
        log.c:174-188 shader dumps)."""
        self.debug(f"{label}:")
        for i, line in enumerate(source.splitlines(), 1):
            self.debug(f"[{i:4d}] {line}")


def log_create(level: LogLevel = LogLevel.INFO,
               callback: Optional[Callable] = None) -> Log:
    """Reference pl_log_create."""
    return Log(level=level, callback=callback)


_default: Optional[Log] = None


def default_log() -> Log:
    global _default
    if _default is None:
        _default = Log(level=LogLevel.WARN)
    return _default
