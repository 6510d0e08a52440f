"""The run's log file (port of ``dr4sr_tpu/utils/logger.py``).

:func:`get_logger` returns the logger the port logs through
(``dr4sr_tpu_torch``: the trainers' epoch lines) with one file sink at
``log/<log_path>`` under the working directory. It adds a stream handler
only when no handler on the logger or its ancestors prints already (the
CLI's ``logging.basicConfig`` does), so no line prints twice.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_LOGGER_NAME = "dr4sr_tpu_torch"
_FORMAT = "[%(asctime)s] %(levelname)s %(message)s"


def _prints(logger: logging.Logger) -> bool:
    """Whether a plain stream handler on ``logger`` or an ancestor it
    propagates to prints its records."""
    node: Optional[logging.Logger] = logger
    while node is not None:
        if any(type(h) is logging.StreamHandler for h in node.handlers):
            return True
        if not node.propagate:
            return False
        node = node.parent
    return False


def get_logger(log_path: Optional[str] = None, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    if not _prints(logger):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    if log_path is not None:
        full = os.path.abspath(log_path if os.path.isabs(log_path)
                               else os.path.join("log", log_path))
        os.makedirs(os.path.dirname(full), exist_ok=True)
        # one active file sink: drop handlers for other files so runs in one
        # process (a sweep) don't append later runs to earlier logs
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler) and h.baseFilename != full:
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
            fh = logging.FileHandler(full)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger
