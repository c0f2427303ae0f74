"""Structured metric logging.

The port's own copy of `relpose_gnn_tpu/utils/logging.py`: metrics go to a
human-readable log line and to a newline-delimited JSON file that tools
can parse (the reference logs free-text loguru lines, train.py:415-416).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping

_FMT = "%(asctime)s | %(levelname)s | %(message)s"


def get_logger(name: str = "relpose_gnn_tpu_torch",
               logfile: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        if not any(isinstance(h, logging.FileHandler)
                   and h.baseFilename == os.path.abspath(logfile)
                   for h in logger.handlers):
            fh = logging.FileHandler(logfile)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, step: int, metrics: Mapping[str, Any], **extra) -> None:
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def log_hyperparams(logger: logging.Logger, cfg: Any, prefix: str = ""
                    ) -> None:
    """Dump a (dataclass or dict) config like train.py:146-170."""
    items = (cfg.__dict__ if hasattr(cfg, "__dict__") else dict(cfg)).items()
    for k, v in items:
        logger.info("%s%s: %s", prefix, k, v)
