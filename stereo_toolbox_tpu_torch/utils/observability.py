"""Per-step scalar logging (counterpart of
``stereo_toolbox_tpu/utils/observability.py``'s `ScalarWriter`).

`ScalarWriter` writes TensorBoard event files through
``torch.utils.tensorboard`` where that imports, and always a JSONL mirror
(``scalars.jsonl``), so the scalars stay machine-readable without
TensorBoard. Only rank 0 of a process group writes; ``log_dir=None`` is a
no-op writer.
"""

from __future__ import annotations

import json
import os
import time

import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class ScalarWriter:
    """Per-step scalar sink: TensorBoard events + JSONL mirror."""

    def __init__(self, log_dir: str | None):
        self._tb = None
        self._jsonl = None
        self.log_dir = log_dir
        if log_dir is None or _rank() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:   # tensorboard optional: JSONL still works
            self._tb = None

    def scalars(self, step: int, **values: float) -> None:
        if self._jsonl is None:
            return
        rec = {"step": int(step), "time": time.time()}
        for key, val in values.items():
            val = float(val)
            rec[key] = val
            if self._tb is not None:
                self._tb.add_scalar(key, val, global_step=int(step))
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
