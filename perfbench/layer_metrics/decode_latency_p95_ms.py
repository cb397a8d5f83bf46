"""decode_latency_p95_ms: the 95th percentile of the request latencies of
the traced run's window after its profiled share (the profiler slows the
ones inside it): from the start of building a request's batch to its
hypothesis string. Layer: the serving loop (infer/work.py's loop:
batching, search, post-processing). Moves decode_graphs_per_s."""


def read(record):
    return record["work"].get("latency_p95_ms")
