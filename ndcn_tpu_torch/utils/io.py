"""Shared file-IO helpers, a copy of ``ndcn_tpu/utils/io.py``."""

from __future__ import annotations

import os
import tempfile


def atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename so readers never see a partial file.

    The temp file lives in the destination directory (``os.replace`` must not
    cross filesystems) and is re-chmodded from mkstemp's 0600 to normal file
    permissions before publishing."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
