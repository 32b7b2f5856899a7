"""Leveled logging (core logger analog: utils/logger.hpp:24-31,
core/src/logger.cpp; env OPENCV_LOG_LEVEL -> OPENCV_TPU_LOG_LEVEL). Port of
opencv_tpu/utils/logger.py, host code."""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "SILENT": logging.CRITICAL + 10,
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARNING": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "VERBOSE": logging.DEBUG - 5,
}


def get_logger(name: str = "opencv_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(levelname)s:%(name)s] %(message)s")
        )
        logger.addHandler(handler)
        level = os.environ.get("OPENCV_TPU_LOG_LEVEL", "WARNING").upper()
        logger.setLevel(_LEVELS.get(level, logging.WARNING))
    return logger
