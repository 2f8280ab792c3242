"""File+stream logger under the experiment path (reference: util/log.py:16-42).

The port's copy of geoformer_tpu/utils/logger.py
(host code, kept name for name): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import logging
import os
import sys
import time


def create_logger(exp_path: str | None = None, name: str = "geoformer_tpu_torch",
                  primary: bool = True) -> logging.Logger:
    """primary=False (non-rank-0 process) logs warnings only, no file —
    the reference's rank-0 logging gate (util/dist.py:36-49)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if primary else logging.WARNING)
    logger.propagate = False
    if logger.handlers:
        return logger
    if not primary:
        logger.addHandler(logging.NullHandler())
        return logger

    fmt = logging.Formatter("[%(asctime)s  %(levelname)s  %(filename)s  line %(lineno)d]  %(message)s")

    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if exp_path is not None:
        os.makedirs(exp_path, exist_ok=True)
        log_file = os.path.join(exp_path, time.strftime("%Y%m%d_%H%M%S", time.localtime()) + ".log")
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    return logger
