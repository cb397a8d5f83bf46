"""feed_ms.train: host milliseconds per train step that the loader's
next batch and the trainer's pack and copy (`Trainer._prep`) take on the
prefetch thread (the harness's spans "feed/next_batch" and "feed/prep"
around those calls). Layer: host batching (data/dataloader.py,
data/batching.py, data/prefetch.py, native/). Moves train_tokens_per_s."""

from perfbench.harness.trace import span_seconds


def read(record):
    steps = record["work"].get("steps")
    if not steps:
        return None
    s = span_seconds(record, "feed/next_batch", "feed/prep")
    return s / steps * 1e3
