"""Run logging: colored stdout on process 0 + per-process log files.

The port's copy of synfmc_tpu/utils/logger.py: parity with the reference's
detectron2-derived ``setup_logger`` (fmc/utils/util.py:82-124): rank-0
colored console, per-rank ``log.txt`` files.
"""

from __future__ import annotations

import logging
import os
import sys
import time


class _ColorFormatter(logging.Formatter):
    GREY, YELLOW, RED, RESET = "\x1b[38;5;245m", "\x1b[33;1m", "\x1b[31;1m", "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        if record.levelno >= logging.ERROR:
            return f"{self.RED}{msg}{self.RESET}"
        if record.levelno >= logging.WARNING:
            return f"{self.YELLOW}{msg}{self.RESET}"
        return msg


def setup_logger(output_dir: str | None = None, process_index: int = 0,
                 name: str = "synfmc_tpu_torch.train") -> logging.Logger:
    """The run's logger: colored stdout on process 0 and ``output_dir/log.txt``
    (``log.txt.rank{N}`` elsewhere).  A second call replaces the handlers of
    the first (closing its file), so that one process's runs neither repeat
    lines nor write into each other's logs; ``close_logger`` ends a run."""
    logger = logging.getLogger(name)
    close_logger(logger)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = "[%(asctime)s %(name)s]: %(levelname)s %(message)s"

    if process_index == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(_ColorFormatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(ch)

    if output_dir:
        filename = os.path.join(output_dir, "log.txt")
        if process_index > 0:
            filename = f"{filename}.rank{process_index}"
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(filename, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Remove and close every handler of ``logger``."""
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()


def format_time(seconds: float) -> str:
    """Human ETA string (reference fmc/utils/util.py:127-148)."""
    days, rem = divmod(int(seconds), 86400)
    hours, rem = divmod(rem, 3600)
    minutes, secs = divmod(rem, 60)
    if days > 0:
        return f"{days}d{hours}h{minutes}m"
    if hours > 0:
        return f"{hours}h{minutes}m"
    if minutes > 0:
        return f"{minutes}m{secs}s"
    return f"{seconds:.1f}s"
