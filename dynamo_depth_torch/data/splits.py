"""Split-file resolution (the port's copy of ``dynamo_depth_tpu.data.splits``).

The reference ships ``splits/<name>/{train,val,test,test_mask}_files.txt``,
vendored under ``<repo>/splits``. Resolution is *per file*, in order:
``$DYNAMO_SPLITS_DIR`` (a user override, e.g. a synthetic test split), then
the repository's directory, so an override directory that defines only one
split still falls through to the vendored ones.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List

_REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def _candidates() -> List[str]:
    return [
        os.environ.get("DYNAMO_SPLITS_DIR", ""),
        osp.join(_REPO_ROOT, "splits"),
    ]


def splits_dir() -> str:
    """First existing candidate directory (kept for callers that want the
    directory itself; file lookups use per-file fall-through)."""
    for c in _candidates():
        if c and osp.isdir(c):
            return c
    raise FileNotFoundError(
        "No splits directory found: set DYNAMO_SPLITS_DIR or vendor the splits under <repo>/splits."
    )


def _resolve(split: str, which: str) -> str:
    rel = osp.join(split, f"{which}_files.txt")
    for c in _candidates():
        if c and osp.exists(osp.join(c, rel)):
            return osp.join(c, rel)
    raise FileNotFoundError(
        f"split file {rel} not found in any of {[c for c in _candidates() if c]}"
    )


def read_split(split: str, which: str = "train") -> List[str]:
    """Read ``splits/<split>/<which>_files.txt`` -> list of '<seg> <frame> [side]'."""
    with open(_resolve(split, which)) as f:
        return f.read().splitlines()


def split_exists(split: str, which: str) -> bool:
    try:
        _resolve(split, which)
        return True
    except FileNotFoundError:
        return False
