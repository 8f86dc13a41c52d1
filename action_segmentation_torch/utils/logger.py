"""Process-wide logger: a single logger writing bare messages to stdout."""

import logging
import sys

logger = logging.getLogger("action_segmentation_torch")
logger.setLevel(logging.DEBUG)

if not logger.handlers:
    _ch = logging.StreamHandler(sys.stdout)
    _ch.setLevel(logging.DEBUG)
    _ch.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_ch)

