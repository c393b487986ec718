"""Incremental lint cache: re-lint only what changed, and what can SEE
what changed.

Counterpart of ``dmlcloud_tpu/lint/cache.py``. One JSON file (default
:data:`DEFAULT_CACHE_PATH`, under the port's cache directory beside
Inductor's, ``~/.cache/dmlcloud_tpu_torch/``) keyed by file path. An entry
holds everything ``lint_paths`` produced for the file: the content hash, the
module-rule findings, the call-graph summary, declared mesh axes, and
serialized suppression directives. On the next run a file whose hash matches
reuses all of it — no re-read of the source beyond hashing, no re-parse —
and the interprocedural DML5xx pass runs over the mix of cached and fresh
summaries exactly as it would cold (it is summary-only by design, so it is
always current).

Invalidation is graph-aware, not just content-aware:

- a changed/new file always re-lints;
- so does every TRANSITIVE reverse importer of a changed file (computed
  from the cached summaries' resolved imports — edit ``serve/kv_pool.py``
  and the scheduler/engine modules that import it re-lint, edit a leaf
  and only its importers do);
- a different rule registry, ``--select``/``--ignore`` set, or cache
  format version drops the whole cache (the config signature is part of
  the file).

Corrupt or unreadable cache files degrade to a cold run — the cache can
never make lint wrong, only slow.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable

__all__ = ["DEFAULT_CACHE_PATH", "LintCache"]

#: what ``--cache`` with no argument uses: the port's cache directory
DEFAULT_CACHE_PATH = os.path.join(os.path.expanduser("~"), ".cache", "dmlcloud_tpu_torch", "dmllint_cache.json")

_CACHE_VERSION = 1


def _config_signature(select, ignore) -> str:
    """Hash of everything that changes findings without changing sources:
    the registered rule ids (module + project + IR) and the select/ignore
    sets."""
    from .engine import IR_RULES, PROJECT_RULES, RULES

    blob = json.dumps(
        {
            "version": _CACHE_VERSION,
            "rules": sorted(RULES) + sorted(PROJECT_RULES) + sorted(IR_RULES),
            "select": sorted(select) if select else None,
            "ignore": sorted(ignore) if ignore else None,
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class LintCache:
    """Plan/store half-pair used by ``lint_paths``: :meth:`plan` splits the
    file list into re-lint vs reuse, :meth:`store` persists the merged run."""

    def __init__(
        self,
        path: str | os.PathLike,
        select=None,
        ignore=None,
        git_state: tuple[str, frozenset[str]] | None = None,
    ):
        #: ``git_state`` (from ``--changed``): ``(HEAD sha, dirty paths)``.
        #: When the cache was written at the SAME commit, files git reports
        #: clean are reused without re-hashing — content-identical by
        #: construction, so findings stay byte-identical to a cold run.
        self.path = os.fspath(path)
        self.signature = _config_signature(select, ignore)
        self.git_state = git_state
        self.entries: dict[str, dict] = {}
        self._cached_head: str | None = None
        self._hashes: dict[str, str] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict) or data.get("config") != self.signature:
            return
        head = data.get("head")
        self._cached_head = head if isinstance(head, str) else None
        files = data.get("files")
        if isinstance(files, dict):
            self.entries = files

    # ------------------------------------------------------------- planning
    def plan(self, files: Iterable[str | os.PathLike]) -> tuple[list[str], dict[str, dict]]:
        """Split ``files`` into ``(to_lint, reuse)``. ``to_lint`` is every
        changed/new/unreadable file plus the transitive reverse importers
        of the changed set; ``reuse`` maps the remaining paths to their
        cached entries."""
        files = [os.fspath(p) for p in files]
        changed: set[str] = set()
        candidates: dict[str, dict] = {}
        # git-trust fast path (--changed): at the SAME recorded HEAD, a
        # git-clean file's content cannot differ from what was hashed —
        # reuse its entry without re-reading the file at all
        trust_clean: frozenset[str] = frozenset()
        if self.git_state is not None and self.git_state[0] == self._cached_head:
            dirty = self.git_state[1]
            trust_clean = frozenset(
                p for p in files if os.path.abspath(p) not in dirty
            )
        for p in files:
            entry = self.entries.get(p)
            if (
                p in trust_clean
                and entry is not None
                and entry.get("gc") is True  # was ALSO clean when stored
                and entry.get("summary") is not None
            ):
                candidates[p] = entry
                continue
            try:
                with open(p, "rb") as f:
                    self._hashes[p] = hashlib.sha256(f.read()).hexdigest()
            except OSError:
                changed.add(p)
                continue
            if (
                entry is not None
                and entry.get("sha") == self._hashes[p]
                and entry.get("summary") is not None
            ):
                candidates[p] = entry
            else:
                changed.add(p)

        # reverse-importer closure over the CACHED import graph: every
        # module whose (old) summary can reach a changed path re-lints too
        if changed and candidates:
            from .callgraph import ProjectGraph

            known = [
                e["summary"]
                for p, e in self.entries.items()
                if p in set(files) and e.get("summary") is not None
            ]
            graph = ProjectGraph(known)
            importers: dict[str, set[str]] = {}
            for p in candidates:
                mod = graph.modules.get(p)
                if mod is None:
                    continue
                for dep in graph.dependencies(mod):
                    importers.setdefault(dep, set()).add(p)
            frontier = list(changed)
            dirty = set(changed)
            while frontier:
                nxt = frontier.pop()
                for imp in importers.get(nxt, ()):
                    if imp not in dirty:
                        dirty.add(imp)
                        frontier.append(imp)
            for p in dirty & set(candidates):
                del candidates[p]
                changed.add(p)

        to_lint = sorted(p for p in files if p not in candidates)
        return to_lint, candidates

    # -------------------------------------------------------------- storing
    def store(self, results: list[dict], reused: dict[str, dict]) -> None:
        """Persist the merged run: fresh results overwrite their entries,
        reused ones carry over, anything no longer scanned is dropped.
        Written atomically; write failures are silent (cache is advisory)."""
        files: dict[str, dict] = dict(reused)
        for r in results:
            path = r["path"]
            sha = self._hashes.get(path)
            if sha is None:
                try:
                    with open(path, "rb") as f:
                        sha = hashlib.sha256(f.read()).hexdigest()
                except OSError:
                    continue
            files[path] = {
                "sha": sha,
                "findings": [f.to_dict() for f in r["findings"]],
                "summary": r.get("summary"),
                "axes": list(r.get("axes", ())),
                "sup": r.get("sup"),
            }
            if self.git_state is not None:
                # the git-trust flag: only an entry stored CLEAN at this
                # HEAD may later skip hashing (a dirty-at-store entry could
                # be reverted to clean with different content than hashed)
                files[path]["gc"] = os.path.abspath(path) not in self.git_state[1]
        payload = {"config": self.signature, "files": files}
        if self.git_state is not None:
            payload["head"] = self.git_state[0]
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
