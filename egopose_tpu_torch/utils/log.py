"""Text logging for the CLIs (counterpart of egopose_tpu/utils/log.py's
create_logger)."""
from __future__ import annotations

import logging
import os


def create_logger(filename=None, file_handle=True):
    logger = logging.getLogger("egopose_tpu_torch")
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    logger.setLevel(logging.DEBUG)
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename and file_handle:
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
