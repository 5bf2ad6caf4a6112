"""Provenance of measurement artifacts (port of fedmse_tpu/utils/platform.py
`capture_provenance`). The reference's `enable_compilation_cache` and
`force_cpu_platform` configure JAX and have no counterpart here."""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional

_GIT_SNAPSHOT: Optional[dict] = None

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# what defines the port's behaviour: a rewritten artifact JSON at the repo
# root matches none of these, so writing one leaves the tree clean
CODE_PATHSPEC = ("fedmse_tpu_torch", "tests", "configs", "*.py")


def _utc() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def capture_provenance() -> dict:
    """{git_commit, git_dirty, captured_utc}: the short HEAD commit, whether
    the code (CODE_PATHSPEC, untracked files included) differs from it,
    and the time of this call. The git fields are pinned at the first
    successful query of the process, so an edit made while a long
    measurement runs cannot restamp its artifact; a failed query is not
    pinned. Never raises: outside a git checkout the git fields are null."""
    global _GIT_SNAPSHOT
    if _GIT_SNAPSHOT is not None:
        return {**_GIT_SNAPSHOT, "captured_utc": _utc()}
    out = {"git_commit": None, "git_dirty": None, "captured_utc": _utc()}
    try:
        out["git_commit"] = subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip()
        out["git_dirty"] = bool(subprocess.run(
            ["git", "-C", REPO, "status", "--porcelain", "--",
             *CODE_PATHSPEC],
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip())
    except Exception:
        pass
    if out["git_commit"] is not None:
        _GIT_SNAPSHOT = {k: out[k] for k in ("git_commit", "git_dirty")}
    return out
