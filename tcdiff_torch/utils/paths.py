"""Run-directory helpers.

`increment_path` (a copy of `tcdiff_tpu/utils/paths.py:14`) mirrors the
reference's non-clobbering run directories (`dataset/preprocess.py:11-30`):
runs/exp -> runs/exp2, runs/exp3, ... so repeated launches never overwrite
earlier experiments.
"""

from __future__ import annotations

import re
from pathlib import Path


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        stem_path = path.with_suffix("")
        existing = [p.name for p in stem_path.parent.glob(f"{stem_path.name}{sep}*")]
        nums = []
        for name in existing:
            m = re.fullmatch(rf"{re.escape(stem_path.name)}{re.escape(sep)}(\d+)(?:\..*)?", name)
            if m:
                nums.append(int(m.group(1)))
        n = max(nums) + 1 if nums else 2
        path = stem_path.parent / f"{stem_path.name}{sep}{n}{suffix}"
    directory = path if path.suffix == "" else path.parent
    if mkdir and not directory.exists():
        directory.mkdir(parents=True, exist_ok=True)
    return path
