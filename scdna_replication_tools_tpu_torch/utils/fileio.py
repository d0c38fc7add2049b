"""Crash-safe file primitives (port of ``utils/fileio.py``, copied whole).

``atomic_write_bytes`` commits the metrics Prometheus textfile
(``obs/metrics.py``): same-directory temp file, fsync BEFORE replace,
unlink on failure, so a reader never sees a partial file.
"""

from __future__ import annotations

import os
import pathlib
import tempfile


def atomic_write_bytes(path, data: bytes) -> None:
    """Commit ``data`` to ``path`` atomically: temp file in the SAME
    directory (os.replace across filesystems is not atomic), fsync,
    replace.  A reader never observes a partial file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, str(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
