"""Logging utilities (counterpart of `mxnet_tpu/log.py`; reference:
python/mxnet/log.py): the level-coloured formatter and `get_logger`."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

PY3 = True

_LABELS = {logging.CRITICAL: "C", ERROR: "E", WARNING: "W", INFO: "I",
           DEBUG: "D"}


class _Formatter(logging.Formatter):
    """A one-letter level label, coloured on a terminal (reference:
    log.py:37)."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _get_color(self, level):
        if level >= ERROR:
            return "\x1b[31m"
        if level >= WARNING:
            return "\x1b[33m"
        return "\x1b[32m"

    def _get_label(self, level):
        return _LABELS.get(level, "U")

    def format(self, record):
        color = self.colored and sys.stderr.isatty()
        fmt = self._get_color(record.levelno) if color else ""
        fmt += self._get_label(record.levelno)
        fmt += "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
        if color:
            fmt += "\x1b[0m"
        fmt += " %(message)s"
        self._style._fmt = fmt
        return super().format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """The deprecated spelling of `get_logger` (reference: log.py:80)."""
    return get_logger(name, filename, filemode, level)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger with the formatter attached once: to ``filename`` (mode
    ``filemode``, default append) or to stderr (reference: log.py:90)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            hdlr = logging.FileHandler(filename, filemode or "a")
        else:
            hdlr = logging.StreamHandler()
        hdlr.setFormatter(_Formatter(colored=not filename))
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger
