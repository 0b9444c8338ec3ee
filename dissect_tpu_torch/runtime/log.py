"""Root-only logging and result-file writing.

Replaces the reference's Message class (message.h:65-83): a log stream
tee'd to stdout and ``<outfile>.log``, plus result writers with
optional gzip (--zout, message.h:32-35).  Only the root rank (rank 0
of a multi-rank run, dissect_tpu/runtime/log.py:19) logs and writes:
on the other ranks the log is silent and result files open onto the
null device.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
from typing import Optional

from dissect_tpu_torch.runtime.mesh import is_root


class Logger:
    """The global log: stdout + optional <outfile>.log tee (misc.changeOutputs)."""

    def __init__(self):
        self._logfile: Optional[io.TextIOBase] = None
        self.verbose = False

    def attach_file(self, out_prefix: str):
        self.close()
        if is_root():
            self._logfile = open(out_prefix + ".log", "w")

    def message(self, *parts):
        if not is_root():
            return
        line = " ".join(str(p) for p in parts)
        sys.stdout.write(line + "\n")
        if self._logfile is not None:
            self._logfile.write(line + "\n")
            self._logfile.flush()

    def debug(self, *parts):
        if self.verbose:
            self.message(*parts)

    def close(self):
        if self._logfile is not None:
            self._logfile.close()
            self._logfile = None


_LOGGER = Logger()


def get_logger() -> Logger:
    return _LOGGER


# --- gzip result-file toggle (--zout, message.h:32-35) ----------------------

_ZOUT = False


def set_zout(flag: bool):
    global _ZOUT
    _ZOUT = bool(flag)


def result_open(path: str, mode: str = "w"):
    """Open a result file, gzip-compressed (path + '.gz') when --zout is
    active — the Message(filename) + boost::iostreams analog; the null
    device on a rank other than the root."""
    if not is_root():
        return open(os.devnull, mode)
    if _ZOUT:
        return gzip.open(path + ".gz", mode + "t")
    return open(path, mode)


def output_open(path: str, mode: str = "w"):
    """Open a result file that --zout leaves plain (GRM, PCA, matrices):
    the file on the root rank, the null device on the others."""
    return open(path if is_root() else os.devnull, mode)
