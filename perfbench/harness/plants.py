"""Faults planted underneath a run's timed path, to show that the check
fails on them (perfbench/tests) and to read its numbers on them at a
cell's own size (calibrate.py). Each takes the object the traffic driver
builds (the Trainer of a train cell, the model of a serve cell), breaks
it in place, and returns a function that undoes what lies outside it.

  unchanged_state  the train step leaves parameters and moments as they
                   were (the optimizer's update does nothing)
  half_batch       the train step's loss leaves out the second half of
                   the batch's rows, the mean taken over the rest
  altered_token    the search's best hypothesis has its first token
                   replaced by the next id, where the search hands it on
  stale_inputs     a train step reads the first batch of its signature:
                   the captured graph's static inputs are not refilled
                   (uncaptured, the step takes that batch's arrays)
"""

from __future__ import annotations


def unchanged_state(trainer):
    trainer.opt.update = lambda grads, phase: None


def half_batch(trainer):
    model = trainer.model
    forward = model.forward

    def halved(batch, data_group=None):
        mask = batch["token_mask"].clone()
        mask[mask.shape[0] // 2:] = False
        return forward(dict(batch, token_mask=mask), data_group=data_group)

    model.forward = halved


def altered_token(model):
    from gtos_tpu_torch.infer import decode

    real = decode.beam_decode_arrays

    def altered(*a, **kw):
        res = real(*a, **kw)
        seqs = res.seqs.clone()
        seqs[:, 0, 1] = (seqs[:, 0, 1] + 1) % model.cfg.token_vocab
        res.seqs = seqs
        return res

    decode.beam_decode_arrays = altered

    def undo():
        decode.beam_decode_arrays = real
    return undo


def stale_inputs(trainer):
    graphs = trainer._step.graphs
    refill = graphs.inputs
    kept = {}

    def stale(key, arrays):
        if key not in kept:
            kept[key] = refill(key, arrays)
        return kept[key]

    graphs.inputs = stale


PLANTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token, "stale_inputs": stale_inputs}
