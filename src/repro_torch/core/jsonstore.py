"""The on-disk JSON store protocol of the persistent caches.

Counterpart of ``repro.core.jsonstore``.  The autotune cache
(:class:`repro_torch.core.autotune.AutotuneCache`), the plan cache
(:class:`repro_torch.core.plan.PlanCache`) and the quarantine store
(:class:`repro_torch.core.resilience.QuarantineStore`) follow it:

* **Document layout**: one JSON object
  ``{"schema": <int>, "registry": "<fingerprint>", "entries": {...}}``.
  The schema gates structural compatibility; the registry fingerprint ties
  every record to the harness set that produced it.  A mismatch on either
  drops the whole file: records are only as durable as the specs behind
  them.  This package never wrote an older schema, so there is no
  migration: a file of another schema is dropped too.
* **Atomic merge-on-save**: ``save`` re-reads the file under an advisory
  ``flock``, merges the in-memory entries over it, and replaces the file
  atomically (a tempfile in the same directory + ``os.replace``).
  Concurrent processes never corrupt the store and rarely lose each
  other's entries.  Without the lock (non-POSIX) it degrades to
  last-writer-wins, never to corruption.
* **Best-effort persistence**: an unwritable location degrades to an
  in-memory store.  A failed save is counted, not raised: the cache serves
  a computation that must not fail on cache trouble.
* **Torn files**: a file that does not parse is moved aside to a
  ``*.corrupt`` sidecar and the store starts fresh.

The files live under ``~/.cache/lilac-torch/`` (or ``$XDG_CACHE_HOME``),
never in the JAX package's ``~/.cache/lilac/``: each package would drop
the other's records, whose fingerprints differ.

Subclass surface: set ``schema_version``, implement ``default_path``;
override ``_merge`` when entries nest, and the ``_note_*`` hooks to feed
the subclass's counters.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

try:  # POSIX advisory locking for concurrent writers; harmless to lose.
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None


def cache_dir() -> Path:
    """``$XDG_CACHE_HOME/lilac-torch`` or ``~/.cache/lilac-torch``."""
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "lilac-torch"


class JsonStore:
    """Versioned, registry-fingerprinted JSON entry store (see the module
    docstring for the protocol)."""

    #: schema written by ``save`` and required on read
    schema_version: int = 1

    def __init__(self, path: Optional[os.PathLike] = None,
                 registry_fingerprint: str = ""):
        self.path = Path(path) if path is not None else self.default_path()
        self.registry_fingerprint = registry_fingerprint
        self.entries: Dict[str, Any] = {}
        self.loaded = False

    # -- subclass surface ----------------------------------------------------

    def default_path(self) -> Path:
        raise NotImplementedError

    def _merge(self, base: Dict[str, Any], incoming: Dict[str, Any],
               overwrite: bool):
        """Merge ``incoming`` into ``base`` in place, flat per key.  With
        ``overwrite=False`` existing keys win (warm start: disk under
        memory); with ``overwrite=True`` incoming wins (save: memory over
        disk)."""
        for k, v in incoming.items():
            if overwrite or k not in base:
                base[k] = v

    def _note_invalidation(self):
        """A whole-file drop: schema or registry-fingerprint mismatch."""

    def _note_save_error(self):
        """Persistence failed (unwritable path); the store stays in memory."""

    def _note_corrupt_recovery(self):
        """A torn file was moved aside to a ``*.corrupt`` sidecar."""

    # -- disk protocol -------------------------------------------------------

    def _quarantine_corrupt(self):
        """Move a file that does not parse out of the read path (kept for
        a post-mortem) and start fresh; renaming rather than deleting stops
        two readers from both finding the same bad file."""
        sidecar = self.path.with_suffix(self.path.suffix + ".corrupt")
        try:
            os.replace(self.path, sidecar)
        except OSError:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self._note_corrupt_recovery()

    def _read_disk(self) -> Dict[str, Any]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except OSError:
            return {}
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            self._quarantine_corrupt()
            return {}
        if not isinstance(doc, dict) \
                or doc.get("schema") != self.schema_version \
                or doc.get("registry") != self.registry_fingerprint:
            self._note_invalidation()
            return {}
        entries = doc.get("entries", {})
        return entries if isinstance(entries, dict) else {}

    def load(self) -> "JsonStore":
        """Warm start: merge the on-disk entries under the in-memory ones."""
        self._merge(self.entries, self._read_disk(), overwrite=False)
        self.loaded = True
        return self

    def save(self):
        """Best-effort persistence (see the module docstring)."""
        try:
            self._save()
        except OSError:
            self._note_save_error()

    def _save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        lock_path = self.path.with_suffix(self.path.suffix + ".lock")
        lock_f = None
        try:
            if fcntl is not None:
                lock_f = open(lock_path, "a+")
                fcntl.flock(lock_f.fileno(), fcntl.LOCK_EX)
            merged = self._read_disk()
            self._merge(merged, self.entries, overwrite=True)
            doc = {"schema": self.schema_version,
                   "registry": self.registry_fingerprint,
                   "entries": merged}
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
                self._maybe_tear()
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        finally:
            if lock_f is not None:
                fcntl.flock(lock_f.fileno(), fcntl.LOCK_UN)
                lock_f.close()

    def _maybe_tear(self):
        """Fault site ``cache_torn_write`` (:mod:`repro_torch.core.faults`):
        the tempfile + ``os.replace`` protocol cannot tear on POSIX, so the
        injection stands in for the wider world (a crashed writer, a
        network file system) by truncating the file just written to half
        its bytes.  The site is the file's stem (``autotune``, ``plans``,
        ``quarantine``)."""
        from repro_torch.core import faults

        if faults.ACTIVE is None \
                or not faults.check("cache_torn_write", self.path.stem):
            return
        try:
            size = os.path.getsize(self.path)
            with open(self.path, "r+b") as f:
                f.truncate(max(1, size // 2))
        except OSError:
            pass
