"""Logging / distributed helpers.

Port of ``hicom_tpu/utils.py``: the rank helpers read ``torch.distributed``
when a process group is initialised (else rank 0 of 1), ``synchronize`` is a
``dist.barrier()`` above one process; ``rank0_print`` and ``build_logger`` are
the JAX package's text.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import torch.distributed as dist

_LOGGERS = {}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def rank0_print(*args, **kwargs):
    if is_main_process():
        print(*args, **kwargs)


def synchronize():
    """Barrier across processes (no-op in one process)."""
    if get_world_size() == 1:
        return
    dist.barrier()


def build_logger(name: str, filename: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """Console (+ optional daily-rotating file) logger (reference utils.py:103-143)."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(fmt)
    logger.addHandler(handler)
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        from logging.handlers import TimedRotatingFileHandler

        fh = TimedRotatingFileHandler(filename, when="D", utc=True)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
