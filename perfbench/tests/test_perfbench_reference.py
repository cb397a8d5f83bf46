"""The plain reference against the port at a small size, in f32 on the
CPU: the same parameter names and shapes; the same training loss and
gradients of a batch from the port's loader, dropout on (the reference
draws its masks from a generator in the state the port's starts from);
the same Adam step; and the search's scores equal to the reference's
scores of the searched tokens."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import program
from perfbench.reference.model import Adam, Reference, init_weights, \
    param_spec
from perfbench.traffic import corpora
from perfbench.traffic.train import STILL_SHARE

SIZES = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=2,
             compute_dtype="float32")


def setup(config_name, tmp_path):
    from perfbench.harness.cell import HERE, load_json

    config = load_json(HERE / "configs" / f"{config_name}.json")
    config["model"] = dict(config["model"], **SIZES)
    corpus = corpora.generate(config["corpus"], 60, 3)
    data = program.read(config["task"], corpus, str(tmp_path), "x")
    vocabs = program.vocabularies(data)
    cfg = program.sizes(config, vocabs)
    dl = program.loader(program.preprocess(data), vocabs, cfg, 1024, True)
    batch = next(iter(dl))
    return config, cfg, vocabs, batch


@pytest.mark.parametrize("config_name", ["c2_amr2", "c4_nmt_ende"])
def test_training_loss_gradients_and_step_match_the_port(config_name,
                                                          tmp_path):
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.optim import Optimizer

    torch.manual_seed(0)
    config, cfg, vocabs, batch = setup(config_name, tmp_path)
    dev = torch.device("cpu")
    model = program.model(cfg, 11, dev).train()
    model.dropout_rng.manual_seed(5)
    loss, _ = model(batch_to_device(batch.arrays(), dev))
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    w = init_weights(param_spec(cfg), 11, dev)
    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = Reference(cfg, P)
    r_loss = ref.loss(program.to_device(batch.arrays(), dev),
                      torch.Generator().manual_seed(5))
    r_grads = torch.autograd.grad(r_loss, list(P.values()))
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    for (k, _), g, rg in zip(model.named_parameters(), grads, r_grads):
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=k)
    tcfg = program.train_config(config)
    opt = Optimizer(tcfg, cfg["d_model"], params)
    opt.step([g.clone() for g in grads])
    adam = Adam(P, cfg["d_model"], tcfg.warmup_steps)
    adam.step(dict(zip(P, r_grads)))
    # leaves whose gradient is nought to rounding (a key's bias under the
    # softmax) move by round-off alone under Adam: left out, as the check
    # leaves them out (traffic/train.py STILL_SHARE)
    norms = {k: float(g.norm()) for k, g in zip(P, r_grads)}
    still = STILL_SHARE * float(np.median(list(norms.values())))
    for (k, p) in model.named_parameters():
        if norms[k] >= still:
            torch.testing.assert_close(p.detach(), P[k].detach(), rtol=1e-5,
                                       atol=1e-7, msg=k)


def test_search_scores_are_the_references(tmp_path):
    from gtos_tpu_torch.infer.decode import beam_decode_arrays

    from perfbench.traffic.serve import scores

    config, cfg, vocabs, batch = setup("c2_amr2", tmp_path)
    dev = torch.device("cpu")
    model = program.model(cfg, 13, dev)
    tv = vocabs[0]
    res = beam_decode_arrays(model, batch.arrays(), beam_size=3,
                             max_steps=12, alpha=0.6, str_id=tv.str_id,
                             end_id=tv.end_id, unk_id=tv.unk_id)
    ref = Reference(cfg, init_weights(param_spec(cfg), 13, dev))
    rows = list(range(len(batch.oov_lists)))
    arrays = batch.arrays()
    sub = {k: torch.from_numpy(np.ascontiguousarray(arrays[k][rows]))
           for k in ("concept", "concept_char", "concept_mask", "rel_index",
                     "cp_seq", "copy_mask")}
    sub["rel_bank"] = torch.from_numpy(arrays["rel_bank"])
    sub["rel_length"] = torch.from_numpy(arrays["rel_length"])
    got = scores(ref, sub, res.seqs[:, 0], res.lengths[:, 0], rows,
                 tv.unk_id, 0.6)
    np.testing.assert_allclose(got, res.scores[rows, 0].numpy(), rtol=1e-5,
                               atol=1e-4)


def test_the_control_rounds_to_float8():
    from perfbench.reference.model import Numerics

    x = torch.linspace(-3, 3, 1001)
    y = Numerics("fp8").r(x)
    assert 0 < float((x - y).abs().max()) < 0.2
    assert len(torch.unique(y)) < 255
    assert torch.equal(Numerics("f32").r(x), x)
