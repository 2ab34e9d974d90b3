"""The port's logger. Counterpart of utils/logger.py.

Levels are the reference's --log_level values; the level comes from
MIXQ_LOG_LEVEL (default "warning"), as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "verbose": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def _make_logger() -> logging.Logger:
    lg = logging.getLogger("mixq_torch")
    if not lg.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s][mixq-torch][%(levelname)s] %(message)s",
            datefmt="%H:%M:%S"))
        lg.addHandler(h)
        lg.propagate = False
    lg.setLevel(_LEVELS.get(os.environ.get("MIXQ_LOG_LEVEL", "warning"),
                            logging.WARNING))
    return lg


logger = _make_logger()


def set_level(level: str) -> None:
    logger.setLevel(_LEVELS[level])
