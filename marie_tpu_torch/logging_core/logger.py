"""Logger (copy of the part of ``marie_tpu/logging_core/logger.py`` that the
pipelines call: ``MarieLogger`` with its env-driven plain or JSON stderr
handler; the YAML logging configs and the request-id context stay in the
JAX package).

Env knobs: ``MARIE_LOG_LEVEL`` (DEBUG/INFO/WARNING/ERROR, default INFO),
``MARIE_LOG_FORMAT`` ("plain" or "json", default plain).
"""

import json
import logging
import os
import sys
from typing import Optional

_LOG_LEVEL_ENV = "MARIE_LOG_LEVEL"
_LOG_FORMAT_ENV = "MARIE_LOG_FORMAT"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "name": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def _build_handler() -> logging.Handler:
    h = logging.StreamHandler(sys.stderr)
    if os.environ.get(_LOG_FORMAT_ENV, "plain").lower() == "json":
        h.setFormatter(_JsonFormatter())
    else:
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s %(message)s", datefmt="%H:%M:%S"))
    return h


class MarieLogger:
    """Thin wrapper over :mod:`logging`: one stderr handler per context."""

    def __init__(self, context: str = "marie", log_level: Optional[str] = None):
        self.logger = logging.getLogger(context)
        self.logger.propagate = False
        if not self.logger.handlers:
            self.logger.addHandler(_build_handler())
        level = log_level or os.environ.get(_LOG_LEVEL_ENV, "INFO")
        self.logger.setLevel(level.upper())

    def debug(self, msg, *args, **kw):
        self.logger.debug(msg, *args, **kw)

    def info(self, msg, *args, **kw):
        self.logger.info(msg, *args, **kw)

    def warning(self, msg, *args, **kw):
        self.logger.warning(msg, *args, **kw)

    def error(self, msg, *args, **kw):
        self.logger.error(msg, *args, **kw)

    def exception(self, msg, *args, **kw):
        self.logger.exception(msg, *args, **kw)


default_logger = MarieLogger("marie")
