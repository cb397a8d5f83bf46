"""mfu.train: the model's operations in the traced window, counted from
each batch's real content (harness/work.py), over the window's seconds
and the card's peak for the compute type (989 TFLOP/s bf16), in percent.
Layer: the model step (models/, train/optim.py). Moves train_tokens_per_s."""


def read(record):
    w = record["work"]
    if not w.get("flops") or record["window_s"] <= 0:
        return None
    return w["flops"] / record["window_s"] / w["peak_flops"] * 100.0
