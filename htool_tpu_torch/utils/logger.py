"""Logger — singleton with levels and a pluggable writer
(``misc/logger.hpp:12-87``: 5 levels, default stdout writer at ERROR).

A copy of ``htool_tpu/utils/logger.py`` (no JAX in it)."""

from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Optional

__all__ = ["LogLevel", "Logger", "logger"]


class LogLevel(IntEnum):
    CRITICAL = 0
    ERROR = 10
    WARNING = 20
    INFO = 30
    DEBUG = 40


class Logger:
    """Meyer-singleton-style logger (``Logger::get_instance()``)."""

    _instance: Optional["Logger"] = None

    def __init__(self):
        self.level = LogLevel.ERROR
        self.writer: Callable[[LogLevel, str], None] = self._default_writer

    @classmethod
    def get_instance(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @staticmethod
    def _default_writer(level: LogLevel, message: str) -> None:
        print(f"[htool_tpu_torch {level.name.lower()}] {message}", file=sys.stderr)

    def set_current_log_level(self, level: LogLevel) -> None:
        self.level = level

    def set_writer(self, writer: Callable[[LogLevel, str], None]) -> None:
        self.writer = writer

    def log(self, level: LogLevel, message: str) -> None:
        if level <= self.level:
            self.writer(level, message)

    def error(self, msg: str) -> None:
        self.log(LogLevel.ERROR, msg)

    def warning(self, msg: str) -> None:
        self.log(LogLevel.WARNING, msg)

    def info(self, msg: str) -> None:
        self.log(LogLevel.INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(LogLevel.DEBUG, msg)


logger = Logger.get_instance()
