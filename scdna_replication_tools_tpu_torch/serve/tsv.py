"""Tab-separated result files, formatted by a pool of processes.

A served request streams back ``output.tsv`` (one row per S cell and
locus: 5.45 million at the flagship shape) and its G1 twin.  pandas
formats them holding the interpreter lock, so on a batched worker the
lanes' stream backs queue behind one another and behind the fits (on an
H100 machine, four flagship requests' stream backs took 295-357 s each
that way; PERF.md).  :class:`TsvWriter` writes the bytes of
``frame.to_csv(path, sep='\\t', index=False)``; a frame longer than
:data:`CHUNK_ROWS` has processes format its rows, a block each, and the
blocks are written in order: pandas formats every row on its own, so
the concatenation is the same file, byte for byte.
"""

from __future__ import annotations

import multiprocessing
import os
import threading
from concurrent.futures import ProcessPoolExecutor

# rows per block; a shorter frame is written by pandas in the caller
CHUNK_ROWS = 250_000
# the pool's processes (fewer on a machine with fewer cores)
PROCESSES = 8


def _rows(block) -> bytes:
    """One block's rows, without the header (a pool process's task)."""
    return block.to_csv(sep="\t", index=False, header=False).encode()


class TsvWriter:
    """``write(frame, path)`` as ``frame.to_csv(path, sep='\\t',
    index=False)``; the pool of spawned processes starts at the first
    long frame and stops at :meth:`close`."""

    def __init__(self):
        self._pool = None
        self._lock = threading.Lock()

    def write(self, frame, path) -> None:
        processes = min(PROCESSES, os.cpu_count() or 1)
        if processes < 2 or len(frame) <= CHUNK_ROWS:
            frame.to_csv(path, sep="\t", index=False)
            return
        with self._lock:
            if self._pool is None:
                self._pool = ProcessPoolExecutor(
                    processes,
                    mp_context=multiprocessing.get_context("spawn"))
            pool = self._pool
        blocks = [frame.iloc[i:i + CHUNK_ROWS]
                  for i in range(0, len(frame), CHUNK_ROWS)]
        with open(path, "wb") as fh:
            fh.write(frame.iloc[:0].to_csv(sep="\t", index=False).encode())
            for part in pool.map(_rows, blocks):
                fh.write(part)

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
