"""Run paths on any fsspec URL: ``gs://bucket/runs/x``, ``s3://...``,
``memory://run`` (fsspec's in-process store, which the tests use) or
``file:///abs/dir``.

``RemotePath`` is the counterpart of the ``etils.epath.Path`` that the JAX
package uses for a URL (reference checkpoint.py:36-50); the card machine has no
etils, and fsspec ships with torch. It has the ``pathlib.Path`` methods the
package calls on a run directory (``/``, ``name``, ``stem``, ``parent``,
``exists``, ``is_dir``, ``read_text``, ``write_text``, ``mkdir``, ``touch``,
``iterdir``, ``glob``, ``unlink``, ``rm``), and ``str``/``os.fspath`` keep the
scheme. Local paths stay ``pathlib.Path``: ``checkpoint.as_run_path`` returns
one or the other, and code written against either takes both.

The filesystem is resolved at the first I/O call, not at construction, so
building and joining URLs (``generate_checkpoint_path("gs://...")``) never
touches the store. ``iterdir`` names its children by joining this URL with the
listed basenames: fsspec's ``ls`` drops the protocol (``memory`` lists
``/run/x``, ``gcs`` lists ``bucket/x``).
"""

from __future__ import annotations

import fnmatch
import os
import posixpath
from typing import Any, Iterator

__all__ = ["RemotePath", "is_remote_path"]


def is_remote_path(path: Any) -> bool:
    """Whether ``path`` is a URL (``scheme://...``), as the reference tests it."""
    return "://" in os.fspath(path)


class RemotePath:
    """A URL with the subset of ``pathlib.Path`` a run directory needs."""

    __slots__ = ("_scheme", "_rest")

    def __init__(self, url: Any):
        url = os.fspath(url)
        scheme, sep, rest = url.partition("://")
        if not sep or not scheme:
            raise ValueError(f"not a URL: {url!r}")
        self._scheme = scheme
        self._rest = rest.rstrip("/")

    # -- the name ---------------------------------------------------------
    def __fspath__(self) -> str:
        return f"{self._scheme}://{self._rest}"

    __str__ = __fspath__

    def __repr__(self) -> str:
        return f"RemotePath({str(self)!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, RemotePath) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))

    def __truediv__(self, other: Any) -> "RemotePath":
        part = os.fspath(other).strip("/")
        return RemotePath(f"{self}/{part}" if part else str(self))

    @property
    def name(self) -> str:
        return self._rest.rsplit("/", 1)[-1]

    @property
    def stem(self) -> str:
        name = self.name
        i = name.rfind(".")
        return name[:i] if i > 0 else name

    @property
    def parent(self) -> "RemotePath":
        if "/" not in self._rest:
            return self
        return RemotePath(f"{self._scheme}://{self._rest.rsplit('/', 1)[0]}")

    # -- I/O through fsspec ----------------------------------------------
    def _fs(self):
        from fsspec.core import url_to_fs

        return url_to_fs(str(self))

    def exists(self) -> bool:
        fs, p = self._fs()
        return bool(fs.exists(p))

    def is_dir(self) -> bool:
        fs, p = self._fs()
        return bool(fs.isdir(p))

    def read_bytes(self) -> bytes:
        fs, p = self._fs()
        return fs.cat_file(p)

    def read_text(self, encoding: str = "utf-8") -> str:
        return self.read_bytes().decode(encoding)

    def write_bytes(self, data: bytes) -> int:
        fs, p = self._fs()
        fs.pipe_file(p, bytes(data))
        return len(data)

    def write_text(self, text: str, encoding: str = "utf-8") -> int:
        self.write_bytes(text.encode(encoding))
        return len(text)

    def mkdir(self, parents: bool = False, exist_ok: bool = False) -> None:
        """``makedirs`` on the store, parents always included (a no-op on an
        object store, whose directories are prefixes); ``FileExistsError`` as
        pathlib raises it."""
        fs, p = self._fs()
        if not exist_ok and fs.exists(p):
            raise FileExistsError(str(self))
        fs.makedirs(p, exist_ok=True)

    def touch(self) -> None:
        if not self.exists():
            self.write_bytes(b"")

    def iterdir(self) -> Iterator["RemotePath"]:
        fs, p = self._fs()
        for entry in fs.ls(p, detail=False):
            name = posixpath.basename(str(entry).rstrip("/"))
            if name:
                yield self / name

    def glob(self, pattern: str) -> list["RemotePath"]:
        """The children whose name matches ``pattern`` (one level)."""
        if not self.is_dir():
            return []
        return [c for c in self.iterdir() if fnmatch.fnmatchcase(c.name, pattern)]

    def unlink(self, missing_ok: bool = False) -> None:
        fs, p = self._fs()
        try:
            fs.rm_file(p)
        except FileNotFoundError:
            if not missing_ok:
                raise

    def rm(self, recursive: bool = True) -> None:
        """Delete this file or tree; a missing path is no error."""
        fs, p = self._fs()
        if fs.exists(p):
            fs.rm(p, recursive=recursive)
