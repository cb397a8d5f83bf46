"""Structured JSONL metrics — port of gtos_tpu/utils/metrics.py: every
record is one JSON line with a wall-clock timestamp."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str] = None, also_stdout: bool = True,
                 enabled: bool = True):
        self.enabled = enabled
        self.also_stdout = also_stdout
        self.fh: Optional[IO] = open(path, "a") if (path and enabled) else None

    def write(self, record: dict):
        if not self.enabled:
            return
        line = json.dumps(dict(record, ts=time.time()))
        if self.fh is not None:
            self.fh.write(line + "\n")
            self.fh.flush()
        if self.also_stdout:
            print(line, file=sys.stdout, flush=True)

    def close(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None
