"""idle_share.train: the share of the traced window in which no kernel,
copy or fill ran on the card (1 minus the union of the device intervals
over the window), in percent. Layer: the device. Moves train_tokens_per_s."""

from perfbench.harness.trace import busy_s


def read(record):
    if not record["device"] or record["window_s"] <= 0:
        return None
    return (1.0 - busy_s(record) / record["window_s"]) * 100.0
