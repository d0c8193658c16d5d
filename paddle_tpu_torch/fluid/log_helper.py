"""Logger factory (ref: python/paddle/fluid/log_helper.py)."""
import logging

__all__ = ["get_logger"]


def get_logger(name, level, fmt=None):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    handler = logging.StreamHandler()
    if fmt:
        handler.setFormatter(logging.Formatter(fmt=fmt))
    logger.addHandler(handler)
    logger.propagate = False
    return logger
