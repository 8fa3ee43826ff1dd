"""Structured run logging (port of ``factorized_tpu/utils/logging.py``):
human-readable lines on stdout in the reference's format and JSONL
records under ``<dir>/<run_id>.jsonl``."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class RunLogger:
    """Writes human-readable lines to stdout (reference format) and JSONL
    records to ``<dir>/<run_id>.jsonl``."""

    def __init__(self, jsonl_dir: Optional[str] = None,
                 run_id: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._fh = None
        if jsonl_dir is not None:
            os.makedirs(jsonl_dir, exist_ok=True)
            run_id = run_id or f"run_{int(time.time() * 1000)}"
            self._fh = open(os.path.join(jsonl_dir, f"{run_id}.jsonl"), "a")
        self.run_id = run_id

    def record(self, kind: str, **fields):
        if self._fh is not None:
            rec = {"kind": kind, "ts": time.time(), **fields}
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()

    def text(self, *args):
        if self.echo:
            print(*args)
            sys.stdout.flush()

    def epoch(self, epoch: int, train_loss: float, valid_loss: float,
              saved: bool, **extra):
        # reference format: "epoch train_loss valid_loss [saving model]"
        if saved:
            self.text(epoch, train_loss, valid_loss, "saving model")
        else:
            self.text(epoch, train_loss, valid_loss)
        self.record("epoch", epoch=epoch, train_loss=train_loss,
                    valid_loss=valid_loss, saved=saved, **extra)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
