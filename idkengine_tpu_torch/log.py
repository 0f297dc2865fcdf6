"""Leveled colored console logger + log.txt mirror. Counterpart:
idkengine_tpu/log.py.

Role of the reference's BBLogger (ref: Logger/Source/Logger.cs:18-40):
lazy-initialized, colored console output with a persistent file mirror.
The logger tree is rooted at `idkengine_tpu_torch`; `IDK_LOG_LEVEL` sets
its level and `IDK_LOG_FILE` the mirror (default `log.txt`, opened at the
first record).
"""
from __future__ import annotations

import logging
import os
import sys

ROOT = "idkengine_tpu_torch"
_COLORS = {
    logging.DEBUG: "\033[90m",
    logging.INFO: "\033[36m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
}
_RESET = "\033[0m"
_initialized = False


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def _init():
    global _initialized
    if _initialized:
        return
    _initialized = True
    root = logging.getLogger(ROOT)
    root.setLevel(os.environ.get("IDK_LOG_LEVEL", "INFO").upper())
    fmt = "[%(levelname)s] %(name)s: %(message)s"
    sh = logging.StreamHandler()
    sh.setFormatter(_ColorFormatter(fmt))
    root.addHandler(sh)
    try:
        fh = logging.FileHandler(os.environ.get("IDK_LOG_FILE", "log.txt"), delay=True)
        fh.setFormatter(logging.Formatter("%(asctime)s " + fmt))
        root.addHandler(fh)
    except OSError:
        pass
    root.propagate = False


def get_logger(name: str = ROOT) -> logging.Logger:
    _init()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
