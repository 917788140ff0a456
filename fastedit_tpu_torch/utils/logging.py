"""Tagged, timestamped, level-filtered logs (a copy of the JAX package's
``utils/logging.py`` under its own logger root).

``get_logger("FastEditor")`` logs as ``HH:MM:SS [fastedit_torch.FastEditor]
message`` to stdout; the level comes from FASTEDIT_LOG_LEVEL (default INFO).
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "fastedit_torch"
_CONFIGURED = False


def get_logger(component: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(name)s] %(message)s", "%H:%M:%S")
        )
        root = logging.getLogger(ROOT)
        root.addHandler(handler)
        root.setLevel(os.environ.get("FASTEDIT_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"{ROOT}.{component}")
