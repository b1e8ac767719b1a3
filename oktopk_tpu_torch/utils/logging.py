"""Hostname-tagged logging + per-experiment log files.

Counterpart of ``oktopk_tpu/utils/logging.py`` (``get_logger`` :18),
copied, with one more keyword: ``console=False`` gives a logger that
writes its file only (``main_trainer`` logs to the console on rank 0
alone, and every rank to its own ``rank{i}.log``).
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional


def _fmt() -> logging.Formatter:
    host = socket.gethostname()
    return logging.Formatter(
        f"%(asctime)s [{host}] %(levelname)s %(name)s: %(message)s")


def get_logger(name: str = "oktopk_tpu_torch",
               logfile: Optional[str] = None, level=logging.INFO,
               console: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        if console:
            sh = logging.StreamHandler()
            sh.setFormatter(_fmt())
            logger.addHandler(sh)
        else:
            logger.propagate = False
    if logfile:
        # a later call with a logfile still attaches it (the logger may
        # exist console-only already)
        target = os.path.abspath(logfile)
        attached = any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == target
            for h in logger.handlers)
        if not attached:
            d = os.path.dirname(target)
            if d:
                os.makedirs(d, exist_ok=True)
            fh = logging.FileHandler(target)
            fh.setFormatter(_fmt())
            logger.addHandler(fh)
    return logger
