"""Run callbacks: code/config snapshotting and progress reporting
(PyTorch counterpart of ``worldrenderer_tpu/utils/callbacks.py``). Plain
objects with ``setup()`` / ``on_step()`` hooks: a git-tracked code copy, the
parsed config as YAML, and a progress file for external monitors.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

from .config import dump_config
from .logging import get_logger

logger = get_logger(__name__)

__all__ = ["CodeSnapshotCallback", "ConfigSnapshotCallback", "ProgressCallback"]


class CodeSnapshotCallback:
    """Copy all git-tracked files into the trial dir."""

    def __init__(self, save_root: str):
        self.save_root = save_root

    def get_file_list(self):
        out = subprocess.run(
            ["git", "ls-files"], capture_output=True, text=True, check=True
        ).stdout
        return [f for f in out.splitlines() if f.strip()]

    def save_code_snapshot(self):
        os.makedirs(self.save_root, exist_ok=True)
        for f in self.get_file_list():
            if not os.path.exists(f):
                continue
            dst = os.path.join(self.save_root, f)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            shutil.copyfile(f, dst)

    def setup(self) -> None:
        try:
            self.save_code_snapshot()
        except Exception as e:
            logger.warning(f"Code snapshot failed: {e}")


class ConfigSnapshotCallback:
    """Dump the parsed config into the trial dir."""

    def __init__(self, config, save_dir: str):
        self.config = config
        self.save_dir = save_dir

    def setup(self) -> None:
        os.makedirs(self.save_dir, exist_ok=True)
        dump_config(os.path.join(self.save_dir, "parsed.yaml"), self.config)


class ProgressCallback:
    """Write step progress to a file for external monitors."""

    def __init__(self, save_path: str, total_steps: Optional[int] = None):
        self.save_path = save_path
        self.total_steps = total_steps

    def on_step(self, step: int, extra: str = "") -> None:
        with open(self.save_path, "w") as f:
            if self.total_steps:
                pct = 100.0 * step / self.total_steps
                f.write(f"{step}/{self.total_steps} ({pct:.1f}%) {extra}".strip())
            else:
                f.write(f"{step} {extra}".strip())
