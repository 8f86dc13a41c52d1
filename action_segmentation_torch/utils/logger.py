"""Process-wide logger: a single logger writing bare messages to stdout,
with ``path_logger(filename)`` attaching a file handler beside it."""

import logging
import sys

logger = logging.getLogger("action_segmentation_torch")
logger.setLevel(logging.DEBUG)

if not logger.handlers:
    _ch = logging.StreamHandler(sys.stdout)
    _ch.setLevel(logging.DEBUG)
    _ch.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_ch)


def path_logger(filename):
    """Attach a file handler (replacing any previous one, so multi-fold
    runs don't duplicate messages into every earlier log file); returns
    the shared logger."""
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    fh = logging.FileHandler(filename, mode="w")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(fh)
    return logger
