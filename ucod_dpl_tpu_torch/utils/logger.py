"""Process-aware logging, jax-free.

The port's copy of :mod:`ucod_dpl_tpu.utils.logger` (the reference's
``engine/utils/logger.py:85-171``): a per-name singleton with console and
rotating-file handlers, rank filtering so that only chosen processes emit,
and a small table formatter for metric dicts.  The rank is
``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import threading
from typing import Dict, Iterable, List, Sequence

_LOCK = threading.Lock()
_INSTANCES: Dict[str, "Logger"] = {}

_FMT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Logger:
    """Rank-filtered logger with console and optional rotating file output."""

    def __new__(cls, name: str = "ucod", *args, **kwargs):
        with _LOCK:
            if name in _INSTANCES:
                return _INSTANCES[name]
            inst = super().__new__(cls)
            inst._initialized = False
            _INSTANCES[name] = inst
            return inst

    def __init__(
        self,
        name: str = "ucod",
        log_file: str | None = None,
        level: str = "INFO",
        ranks: Sequence[int] = (0,),
        max_bytes: int = 10 * 1024 * 1024,
        backup_count: int = 5,
    ):
        if self._initialized:
            # a bare get_logger() (extractor, datasets) may have made the
            # singleton before the Runner asks for a file: honour a newly
            # requested log_file and ranks
            if log_file:
                self._attach_file(log_file, max_bytes, backup_count)
            if tuple(ranks) != (0,):
                self.ranks = list(ranks)
            return
        self._initialized = True
        self.name = name
        self.ranks = list(ranks)
        self._file_paths: set = set()
        self._logger = logging.getLogger(name)
        self._logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self._logger.propagate = False
        if not self._logger.handlers:
            console = logging.StreamHandler()
            console.setFormatter(logging.Formatter(_FMT))
            self._logger.addHandler(console)
        if log_file:
            self._attach_file(log_file, max_bytes, backup_count)

    def _attach_file(self, log_file: str, max_bytes: int, backup_count: int) -> None:
        path = os.path.abspath(log_file)
        if path in self._file_paths:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(path, maxBytes=max_bytes, backupCount=backup_count)
        fileh.setFormatter(logging.Formatter(_FMT))
        self._logger.addHandler(fileh)
        self._file_paths.add(path)

    def _should_emit(self) -> bool:
        return _process_index() in self.ranks

    def log(self, msg, level: str = "INFO") -> None:
        if self._should_emit():
            self._logger.log(getattr(logging, level.upper(), logging.INFO), msg)

    def info(self, msg) -> None:
        self.log(msg, "INFO")

    def warning(self, msg) -> None:
        self.log(msg, "WARNING")

    def error(self, msg) -> None:
        self.log(msg, "ERROR")

    def log_table(self, table: Dict[str, Iterable]) -> None:
        """Log a dict of column name -> values as an aligned text table."""
        if not self._should_emit():
            return
        cols: List[str] = list(table.keys())
        rows = list(zip(*[list(v) for v in table.values()])) if table else []
        widths = [
            max(len(str(c)), *(len(str(r[i])) for r in rows)) if rows else len(str(c))
            for i, c in enumerate(cols)
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        header = "|" + "|".join(f" {str(c):<{w}} " for c, w in zip(cols, widths)) + "|"
        lines = [sep, header, sep]
        for r in rows:
            lines.append("|" + "|".join(f" {str(v):<{w}} " for v, w in zip(r, widths)) + "|")
        lines.append(sep)
        self._logger.info("\n" + "\n".join(lines))


def get_logger(name: str = "ucod", **kwargs) -> Logger:
    return Logger(name, **kwargs)
