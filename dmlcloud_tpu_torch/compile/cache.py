"""Persistent compilation cache: wiring, stats, and precompile hit accounting.

Counterpart of ``dmlcloud_tpu/compile/cache.py``. There the cache is jax's
persistent XLA cache; here it is Inductor's: its cache directory
(``TORCHINDUCTOR_CACHE_DIR``), under which sit the FX-graph cache
(``fxgraph/``: compiled graphs, keyed by the graph, the inputs' metadata and
the compiler's configuration), the AOTAutograd cache (``aotautograd/``: the
joint forward/backward split) and the Triton kernels Inductor generated. A
fresh process that compiles a graph already in the directory loads it
instead of compiling it; on a shared filesystem the first job to compile pays
for everyone (entries are content-addressed and written atomically).

``configure_cache`` is the one entry point (called by
``TrainingPipeline(compile_cache=...)`` before any compilation, or directly at
program start). Resolution order for the directory:

1. an explicit path argument,
2. ``$DMLCLOUD_COMPILE_CACHE_DIR``,
3. whatever ``TORCHINDUCTOR_CACHE_DIR`` is already set to,
4. ``~/.cache/dmlcloud_tpu_torch/inductor``.

Stats are two-layered: ``cache_stats()`` reports the on-disk population
(FX-graph and AOTAutograd entries and the directory's bytes, shared across
every process using it) plus this process's precompile counters (hits =
precompiled signatures whose graphs Inductor loaded from the cache, misses =
those it had to compile). Whether a compilation hit is what Inductor's own
counters say (``torch._dynamo.utils.counters``: ``fxgraph_cache_hit`` /
``fxgraph_cache_miss`` and ``autograd_cache_hit`` / ``autograd_cache_miss``);
a growing entry count cannot say it, since one compilation writes several
entries. On shared filesystems only process 0 should log them
(``TrainingPipeline`` does).
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = [
    "ENV_VAR",
    "INDUCTOR_ENV_VAR",
    "DEFAULT_CACHE_DIR",
    "configure_cache",
    "resolve_cache_dir",
    "configured_cache_dir",
    "entry_count",
    "compile_counters",
    "record_compile",
    "cache_stats",
    "reset_process_stats",
]

ENV_VAR = "DMLCLOUD_COMPILE_CACHE_DIR"
INDUCTOR_ENV_VAR = "TORCHINDUCTOR_CACHE_DIR"
DEFAULT_CACHE_DIR = "~/.cache/dmlcloud_tpu_torch/inductor"
#: the subdirectories of Inductor's cache directory that hold cache entries
_ENTRY_DIRS = ("fxgraph", "aotautograd")

_lock = threading.Lock()
_aot_hits = 0
_aot_misses = 0
_aot_compile_ms = 0.0


def _inductor_default_dir() -> str | None:
    """Inductor's own temporary default (``/tmp/torchinductor_<user>``), or
    None when this torch does not expose it."""
    try:
        from torch._inductor.runtime.cache_dir_utils import default_cache_dir
    except ImportError:
        return None
    return os.path.abspath(default_cache_dir())


def configured_cache_dir() -> str | None:
    """The directory Inductor's persistent caches currently write to, or None
    when none is set. Inductor writes its temporary default into
    ``TORCHINDUCTOR_CACHE_DIR`` on its own (at its first compilation, and in
    recent torch already when Dynamo is imported): that value is not a
    configured cache, so it reads as None, as on a process that set nothing."""
    value = os.environ.get(INDUCTOR_ENV_VAR) or None
    if value is not None and os.path.abspath(value) == _inductor_default_dir():
        return None
    return value


def resolve_cache_dir(cache_dir: Any = True) -> str | None:
    """Resolve the cache directory per the module docstring's order without
    touching the process's configuration. ``None``/``False`` disables
    (returns None)."""
    if cache_dir in (None, False):
        return None
    if isinstance(cache_dir, (str, os.PathLike)):
        chosen = os.fspath(cache_dir)
    else:  # True / anything truthy: env var, existing config, default
        chosen = os.environ.get(ENV_VAR) or configured_cache_dir() or DEFAULT_CACHE_DIR
    return os.path.abspath(os.path.expanduser(chosen))


def configure_cache(cache_dir: Any = True, aggressive: bool = True) -> str | None:
    """Point Inductor's persistent caches at ``cache_dir`` (resolved as above),
    creating the directory. Must run before the first compilation of the
    graphs it should cover. Returns the resolved directory (None when
    disabled).

    Inductor keeps compiled graphs in memory as well, so a graph compiled
    earlier in the process would be served from there instead of the new
    directory; when the directory changes those in-memory caches are dropped.
    ``aggressive`` (default) also switches the FX-graph and AOTAutograd caches
    on should the process have them off: a cache entry costs kilobytes, a cold
    compile of a train step tens of seconds."""
    resolved = resolve_cache_dir(cache_dir)
    if resolved is None:
        return None
    os.makedirs(resolved, exist_ok=True)
    # the raw value: graphs compiled into Inductor's own default count too
    previous = os.environ.get(INDUCTOR_ENV_VAR) or None
    os.environ[INDUCTOR_ENV_VAR] = resolved
    if previous is not None and os.path.abspath(previous) != resolved:
        try:
            from torch._inductor.utils import clear_inductor_caches

            clear_inductor_caches()
        except Exception:  # a private API; the new directory still applies to new graphs
            pass
    if aggressive:
        import torch._functorch.config as functorch_config
        import torch._inductor.config as inductor_config

        inductor_config.fx_graph_cache = True
        functorch_config.enable_autograd_cache = True
    return resolved


def _entry_files(directory: str) -> list[str]:
    files = []
    for sub in _ENTRY_DIRS:
        for root, _, names in os.walk(os.path.join(directory, sub)):
            files.extend(os.path.join(root, n) for n in names if not n.startswith(".") and not n.endswith(".tmp"))
    return files


def entry_count(directory: str | None = None) -> int | None:
    """Number of FX-graph and AOTAutograd entries in the cache dir (None if
    disabled)."""
    directory = directory or configured_cache_dir()
    if directory is None:
        return None
    return len(_entry_files(directory))


def compile_counters() -> dict[str, int]:
    """Inductor's process-wide cache counters: FX-graph and AOTAutograd hits
    and misses so far."""
    from torch._dynamo.utils import counters

    return {
        "fxgraph_hit": int(counters["inductor"]["fxgraph_cache_hit"]),
        "fxgraph_miss": int(counters["inductor"]["fxgraph_cache_miss"]),
        "autograd_hit": int(counters["aot_autograd"]["autograd_cache_hit"]),
        "autograd_miss": int(counters["aot_autograd"]["autograd_cache_miss"]),
    }


def record_compile(hit: bool, elapsed_ms: float) -> None:
    """Account one precompile-phase compilation for this process's stats."""
    global _aot_hits, _aot_misses, _aot_compile_ms
    with _lock:
        if hit:
            _aot_hits += 1
        else:
            _aot_misses += 1
        _aot_compile_ms += float(elapsed_ms)


def reset_process_stats() -> None:
    global _aot_hits, _aot_misses, _aot_compile_ms
    with _lock:
        _aot_hits = _aot_misses = 0
        _aot_compile_ms = 0.0


def cache_stats() -> dict:
    """On-disk population + this process's precompile counters, JSON-encodable.

    When the cache is not enabled yet, ``dir`` still reports what
    ``configure_cache(True)`` *would* use (env var or default)."""
    enabled_dir = configured_cache_dir()
    directory = enabled_dir or resolve_cache_dir(True)
    entries = size = 0
    if enabled_dir and os.path.isdir(enabled_dir):
        files = _entry_files(enabled_dir)
        entries = len(files)
        for f in files:
            try:
                size += os.path.getsize(f)
            except OSError:
                pass
    with _lock:
        hits, misses, ms = _aot_hits, _aot_misses, _aot_compile_ms
    return {
        "enabled": enabled_dir is not None,
        "dir": directory,
        "entries": entries,
        "size_bytes": size,
        "aot_hits": hits,
        "aot_misses": misses,
        "aot_compile_ms": round(ms, 3),
    }
