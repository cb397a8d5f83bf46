"""host_launches.train: the host's launch calls per train step in the
traced window (kernel and graph launches, asynchronous copies and fills,
from the profiler's runtime events). Layer: step capture
(utils/graphs.py, train/trainer.py). Moves train_tokens_per_s."""


def read(record):
    steps = record["work"].get("steps")
    if not steps:
        return None
    return record["host_launches"] / steps
