"""The results-folder guard (counterpart of
phenaki_tpu/utils/results_folder.py).

Before reusing a non-empty results folder, ask y/n whether to clear it, but
only on an attached terminal and on rank 0 of a process group (or with no
group); anywhere else keep the existing files: never block, never delete
unasked.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path
from typing import Optional

import torch.distributed as dist


def yes_or_no(question: str) -> bool:
    answer = input(f"{question} (y/n) ")
    return answer.lower() in ("yes", "y")


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def prepare_results_folder(path, clear_previous: Optional[bool] = None) -> Path:
    """Create `path`, clearing a previous experiment first when asked.

    clear_previous: True removes existing contents, False keeps them, None
    asks on a terminal (rank 0 only) and keeps them otherwise."""
    folder = Path(path)
    if folder.exists() and any(folder.iterdir()):
        if clear_previous is None:
            interactive = sys.stdin is not None and sys.stdin.isatty()
            clear_previous = interactive and process_rank() == 0 and yes_or_no(
                "do you want to clear previous experiment checkpoints and results?")
        if clear_previous:
            shutil.rmtree(folder)
    folder.mkdir(parents=True, exist_ok=True)
    return folder
