"""Rank-prefixed logging (counterpart of horovod_tpu/common/hvd_logging.py).

A thin layer over the standard logging module with the JAX package's
env contract: HOROVOD_LOG_LEVEL (trace..fatal, default warning),
HOROVOD_LOG_HIDE_TIME, and HOROVOD_LOG_FORMAT=json for one JSON object a
line. The rank and elastic round are read for each record from the
port's `core/topology`, so a line after a re-init carries the new rank.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG,   # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}
LOGGER_NAME = "horovod_tpu_torch"

_logger: logging.Logger | None = None


class _ContextFilter(logging.Filter):
    """Stamp each record with the current rank and elastic round."""

    def filter(self, record: logging.LogRecord) -> bool:
        from horovod_tpu_torch.core import topology
        rank = topology.rank_or_none()
        record.hvd_rank = "-" if rank is None else rank
        record.hvd_round = os.environ.get("HOROVOD_ELASTIC_ROUND", "") or "-"
        return True


class _JsonFormatter(logging.Formatter):
    """HOROVOD_LOG_FORMAT=json: one structured object per line."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
                  + f".{int(record.msecs):03d}",
            "level": record.levelname.lower(),
            "rank": getattr(record, "hvd_rank", "-"),
            "round": getattr(record, "hvd_round", "-"),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj)


def _make_formatter() -> logging.Formatter:
    fmt_kind = os.environ.get("HOROVOD_LOG_FORMAT", "text").strip().lower()
    if fmt_kind == "json":
        return _JsonFormatter()
    hide_time = os.environ.get("HOROVOD_LOG_HIDE_TIME", "").lower() in (
        "1", "true", "yes")
    fmt = "[%(levelname)s | rank %(hvd_rank)s] %(message)s" if hide_time \
        else "%(asctime)s [%(levelname)s | rank %(hvd_rank)s] %(message)s"
    return logging.Formatter(fmt)


def get_logger() -> logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger(LOGGER_NAME)
    level = _LEVELS.get(os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower(),
                        logging.WARNING)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        handler.addFilter(_ContextFilter())
        logger.addHandler(handler)
        logger.propagate = False
    _logger = logger
    return _logger


def reset_for_tests() -> None:
    """Drop the cached logger and its handlers so the next get_logger()
    re-reads HOROVOD_LOG_LEVEL / HOROVOD_LOG_FORMAT / _HIDE_TIME."""
    global _logger
    logger = logging.getLogger(LOGGER_NAME)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    _logger = None
