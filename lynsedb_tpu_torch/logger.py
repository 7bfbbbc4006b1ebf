"""Central logger (reference: python/lynse/logger.py)."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("lynsedb_tpu")

if not logger.handlers:
    level = os.environ.get("LYNSE_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(handler)
    log_path = os.environ.get("LYNSE_LOG_PATH")
    if log_path:
        fh = logging.FileHandler(log_path)
        fh.setFormatter(handler.formatter)
        logger.addHandler(fh)
