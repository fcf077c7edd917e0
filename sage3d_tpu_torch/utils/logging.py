"""Logging utilities: silent mode, dual console+file logging, keyword filters.

Re-implementation of the reference's ad-hoc logging stack (run_benchmark.py:
22-68 global print filter, :1152-1214 SilentPrintFilter, :1844-1956
log_and_print; SILENT_LOGGING_MODE env var read by env/detector modules) as a
small explicit API instead of print monkey-patching.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import IO, Iterable, Optional

SILENT_ENV = "SILENT_LOGGING_MODE"


def silent_mode() -> bool:
    return bool(os.environ.get(SILENT_ENV, False))


class EpisodeLogger:
    """Dual console+file logger with optional keyword filtering.

    ``important_keywords`` always print; ``excluded_keywords`` never print to
    console (both still go to the file) — the SilentPrintFilter contract
    (run_benchmark.py:1152-1214).
    """

    def __init__(self, log_path: Optional[str] = None, quiet: bool = False,
                 important_keywords: Iterable[str] = ("[ERROR]", "[PROGRESS]",
                                                      "[SUCCESS]"),
                 excluded_keywords: Iterable[str] = ("[DEBUG]",)):
        self.quiet = quiet or silent_mode()
        self.important = tuple(important_keywords)
        self.excluded = tuple(excluded_keywords)
        self._fh: Optional[IO] = None
        if log_path:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(log_path, "a")

    def log(self, msg: str) -> None:
        if self._fh is not None:
            self._fh.write(f"{time.strftime('%H:%M:%S')} {msg}\n")
            self._fh.flush()
        if self.quiet and not any(k in msg for k in self.important):
            return
        if any(k in msg for k in self.excluded):
            return
        print(msg, file=sys.stdout)

    __call__ = log

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
