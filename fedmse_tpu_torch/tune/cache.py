"""Backend+shape-keyed JSON tuning cache with exact-signature invalidation
(port of fedmse_tpu/tune/cache.py, the same file format).

One file, one schema:

    {"version": 1,
     "sites": {"<site>": [{"signature": {...}, "choice": ...,
                           "measured_at": <unix>, ...extras}, ...]}}

The SIGNATURE is the invalidation rule: a lookup returns an entry only
when its JSON-normalized signature equals the caller's exactly (backend,
device name, probe shape, candidate set: everything the measurement
depended on). A mismatched entry is invisible and the caller falls through
to its default or re-measures; there is no fuzzy matching.

The default file is `TUNE_CACHE_TORCH.json` at the repository root, read
only if present (`FEDMSE_TUNE_CACHE` points elsewhere). Both packages
write the same schema, so either reads the other's file; the JAX
package's entries carry its backends ('tpu', 'cpu' with device 'cpu') and
the port's 'cuda' (or 'cpu' with device 'torch-cpu'), so neither package
ever matches the other's measurements.

Writes to disk happen only when FEDMSE_TUNE=1 is set or the cache was
constructed writable; an un-gated `store` updates the in-process copy
only, so a process that measured once does not measure again and the
tree stays clean. Disk writes are atomic (tmp + os.replace) and re-read on
an mtime change, so concurrent readers see whole files only. An
unreadable or corrupt file reads as an empty cache.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

DEFAULT_PATH = Path(__file__).resolve().parents[2] / "TUNE_CACHE_TORCH.json"
ENV_PATH = "FEDMSE_TUNE_CACHE"    # override the cache file location
ENV_WRITE = "FEDMSE_TUNE"         # "1" = stores may write to disk
VERSION = 1


def normalize_signature(sig: Any) -> Any:
    """Canonical JSON image of a signature (sorted keys, tuples->lists):
    what equality is defined over, in memory and on disk."""
    return json.loads(json.dumps(sig, sort_keys=True))


class TuningCache:
    """See the module docstring. Thread-safe; the file is memoized on
    (mtime_ns, size) and parsed again only when it changes."""

    def __init__(self, path: Optional[os.PathLike] = None,
                 writable: Optional[bool] = None) -> None:
        if path is None:
            path = os.environ.get(ENV_PATH) or DEFAULT_PATH
        self.path = Path(path)
        self._writable = writable
        self._lock = threading.Lock()
        self._stat_key: Any = ()
        self._data: Dict[str, Any] = {"version": VERSION, "sites": {}}
        self._dirty = False  # un-gated stores live only in self._data

    @property
    def writable(self) -> bool:
        if self._writable is None:
            return os.environ.get(ENV_WRITE) == "1"
        return bool(self._writable)

    def _read_locked(self) -> Dict[str, Any]:
        try:
            st = self.path.stat()
            key = (st.st_mtime_ns, st.st_size)
        except FileNotFoundError:
            key = None
        if key == self._stat_key or (key is None and self._dirty):
            return self._data
        data: Dict[str, Any] = {"version": VERSION, "sites": {}}
        if key is not None:
            try:
                loaded = json.loads(self.path.read_text())
            except (OSError, ValueError):
                loaded = None  # unreadable == empty: callers re-measure
            if isinstance(loaded, dict) and loaded.get("version") == VERSION \
                    and isinstance(loaded.get("sites"), dict):
                data = loaded
        self._stat_key = key
        self._data = data
        self._dirty = False
        return data

    def lookup(self, site: str, signature: Any) -> Optional[Dict[str, Any]]:
        """The entry whose signature matches EXACTLY, else None."""
        sig = normalize_signature(signature)
        with self._lock:
            for entry in self._read_locked()["sites"].get(site, []):
                if isinstance(entry, dict) and entry.get("signature") == sig:
                    return dict(entry)
        return None

    def store(self, site: str, signature: Any, choice: Any,
              **extras: Any) -> Dict[str, Any]:
        """Insert or replace the entry for (site, signature). Written to
        disk only when `writable`; always kept in memory."""
        entry = normalize_signature({"signature": signature,
                                     "choice": choice,
                                     "measured_at": time.time(), **extras})
        with self._lock:
            data = self._read_locked()
            rows = data["sites"].setdefault(site, [])
            rows[:] = [e for e in rows
                       if e.get("signature") != entry["signature"]]
            rows.append(entry)
            if self.writable:
                self._write_locked(data)
            else:
                self._dirty = True
        return dict(entry)

    def _write_locked(self, data: Dict[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.write("\n")
            os.chmod(tmp, 0o644)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        st = self.path.stat()
        self._stat_key = (st.st_mtime_ns, st.st_size)
        self._data = data
        self._dirty = False

    def get_or_measure(self, site: str, signature: Any,
                       measure: Callable[[], Dict[str, Any]]
                       ) -> Dict[str, Any]:
        """The cached entry on an exact signature match; otherwise run
        `measure` (returning {"choice": ..., ...extras}) and store it. The
        returned entry carries "cached": True / False."""
        hit = self.lookup(site, signature)
        if hit is not None:
            return {**hit, "cached": True}
        result = dict(measure())
        choice = result.pop("choice")
        entry = self.store(site, signature, choice, **result)
        return {**entry, "cached": False}


_default: Optional[TuningCache] = None


def default_cache() -> TuningCache:
    """The process-wide cache at the env-resolved path (rebuilt when
    FEDMSE_TUNE_CACHE changes)."""
    global _default
    path = os.environ.get(ENV_PATH) or str(DEFAULT_PATH)
    if _default is None or str(_default.path) != str(path):
        _default = TuningCache(path)
    return _default
