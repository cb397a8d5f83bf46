"""Training: the optimizer, the checkpoint format, the Trainer and the
`python -m gtos_tpu_torch.train.train` CLI."""
