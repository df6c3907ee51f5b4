"""Stdlib logger factory (parity: reference utils/logging.py:6-35).

The port's copy of ``dvs_of_training_framework_tpu/utils/logging.py``.
"""
import logging
import sys


_FORMAT = ("[%(asctime)s] [%(levelname)s] "
           "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s")


def create_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """Create a configured stdout logger.

    Args:
        name: logger name (required).
        level: logging level.
    """
    if name is None:
        raise ValueError("name for logger cannot be None")
    logger_ = logging.getLogger(name)
    if logger_.handlers:
        return logger_
    logger_.setLevel(level)
    logger_.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger_.addHandler(handler)
    return logger_


logger = create_logger("DVS_OF_TPU")
