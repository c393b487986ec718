"""Build and load the port's host library (``pack.cpp`` and
``interleave.cpp``) with ctypes.

The reference ships ``native/build.sh``; here the library is built at first
use with the same command, ``g++ -O3 -fPIC -shared -std=c++17 -pthread``, into
``native/build/`` (named by a hash of the sources and flags). The compiler
writes a file named after the process and ``os.replace`` moves it into place,
so processes that build at once do not race. Without ``g++``, or when the
build fails, ``load_symbol`` returns None and the callers take the Python
path (bit-identical, slower), as the reference does without its library;
``build_error`` then says why.

``CALLS`` counts the calls that went through the library, by kernel, so a
caller can show that the native path was taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "interleave.cpp", _HERE / "pack.cpp")
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
#: where the library is built (``reset`` moves it)
BUILD_DIR = _HERE / "build"
#: calls made through the library since the last ``reset_calls``
CALLS = {"pack": 0, "interleave": 0}
#: why the library is not loaded (None: loaded, or not tried yet)
build_error: str | None = None

_lock = threading.Lock()
_LIB = None
_TRIED = False


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def reset(build_dir: str | os.PathLike | None = None) -> None:
    """Forget the loaded library; the next use builds (or finds) it in
    ``build_dir`` (default ``native/build/``)."""
    global _LIB, _TRIED, BUILD_DIR, build_error
    with _lock:
        _LIB, _TRIED, build_error = None, False, None
        BUILD_DIR = Path(build_dir) if build_dir is not None else _HERE / "build"


def lib_path() -> Path:
    """The library's path: named by a hash of the sources and the flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdml_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    ``RuntimeError`` without ``g++`` or on a compile error."""
    path = lib_path()
    if path.is_file():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native pack/interleave library is built at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def loaded_path() -> Path | None:
    """The loaded library's path, building it on first call; None when it
    cannot be built."""
    global _LIB, _TRIED, build_error
    with _lock:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as exc:
                _LIB, build_error = None, str(exc)
        return Path(_LIB._name) if _LIB is not None else None


def load_symbol(name: str, restype, argtypes):
    """The named function of the library with its signature bound, or None
    when the library cannot be built or lacks the symbol."""
    if loaded_path() is None:
        return None
    try:
        fn = getattr(_LIB, name)
    except AttributeError:
        return None
    fn.restype = restype
    fn.argtypes = argtypes
    return fn
