"""batchify_ms.serve: host milliseconds per served batch that the
serving loader's next batch takes (the harness's span "serve/batchify").
Layer: host batching. Moves decode_graphs_per_s."""

from perfbench.harness.trace import span_seconds


def read(record):
    batches = record["work"].get("batches")
    if not batches:
        return None
    return span_seconds(record, "serve/batchify") / batches * 1e3
