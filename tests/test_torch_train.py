"""The port's training slice against the JAX package on the CPU in f32:
the teacher-forced loss and every parameter gradient, label smoothing,
five optimizer steps, dropout, checkpoint/resume through the CLI, and the
corpus BLEU of the dev hook.

The same seeded training batch (batchify for_train=True with local banks,
so the JAX side runs its scatter-free localize backward and its Pallas
backward under the interpreter) and the JAX init's parameters, converted
by gtos_tpu_torch.convert, go through both packages with dropout 0. Flax
gradient trees map onto the port's names as parameter trees do. Each test
states its tolerance."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.train import TrainState, make_optimizer, make_train_step
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu.utils.config import TrainConfig as JaxTrainConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.data import batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.components import Dropout
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.train.train import main as train_main
from gtos_tpu_torch.train.trainer import Trainer
from gtos_tpu_torch.infer.work import main as work_main
from gtos_tpu_torch.utils.bleu import corpus_bleu, corpus_chrf
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

torch.set_num_threads(2)

# the decoder's attention key biases add one constant to a whole score
# row, which the softmax cancels: their gradient is zero in exact
# arithmetic, and both packages hold rounding noise there
ZERO_GRAD = ("decoder.layer0.self_attn.k_proj.bias",
             "decoder.layer0.cross_attn.k_proj.bias")

SMALL = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=1,
             char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
             max_oov=16, max_target_len=32, dropout=0.0)


def _models(**cfg):
    """Both packages' models from one flax init, and the same training
    batch (local banks and the localize sort auxiliaries) in each."""
    graphs, targets = jax_corpus(6, seed=3)
    jv = jax_build_vocabs(graphs, targets)
    ja = jax_batchify(jax_preprocess(graphs, targets), *jv,
                      batch_size_bucket=8, for_train=True,
                      build_local_banks=True).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batchify(preprocess(g2, t2), *build_vocabs(g2, t2),
                  batch_size_bucket=8, for_train=True,
                  build_local_banks=True).arrays()
    tv, cv, rv, chv, _ = jv
    kw = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
              relation_vocab=len(rv), char_vocab=len(chv), **cfg)
    jm = JaxGenerator(JaxModelConfig(
        **kw, attention_impl="pallas_local_interpret"))
    params = jm.init({"params": jax.random.PRNGKey(0)}, ja,
                     deterministic=True)
    pcfg = ModelConfig(**kw, attention_impl="pallas_local")
    pm = Generator(pcfg, device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return jm, params, ja, pm, pcfg, pa


@pytest.mark.parametrize("copy_impl,smoothing,tol", [
    # the JAX scatter lands the copy mass as the port does: f32 sums in
    # another order
    ("scatter", 0.1, dict(rtol=1e-5, atol=1e-7)),
    # the JAX one-hot matmul rounds the copy weights to bf16 twice
    # (split precision, generator.py:174-186): its copy mass is exact to
    # about 1e-6 relative, and the gradients carry that through the whole
    # model, up to ~6e-5 absolute at gradients of ~0.1
    ("onehot", 0.0, dict(rtol=2e-3, atol=2e-4)),
])
def test_loss_and_every_gradient_match_jax(copy_impl, smoothing, tol):
    """Generator.forward (teacher-forced, label-smoothed over the real
    token vocab) and autograd of it against jax.value_and_grad of the JAX
    model: loss, acc, n_tok and every parameter's gradient."""
    jm, params, ja, pm, _, pa = _models(copy_impl=copy_impl,
                                        label_smoothing=smoothing)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, ja, deterministic=True), has_aux=True))(params)
    pm.train()
    names, ps = zip(*pm.named_parameters())
    loss, met = pm(batch_to_device(pa, "cpu"))
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               atol=1e-6)
    assert met["n_tok"].item() == float(jmet["n_tok"])
    ref = state_dict_from_flax(jax.device_get(jgrads))
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), **tol,
                                   err_msg=name)


def test_label_smoothing_spreads_over_the_token_vocab_only():
    """The smoothed loss is (1-eps)*NLL + eps*mean(-logp[:token_vocab]) of
    the same log-probs, as the JAX package has it: the port's loss at
    eps=0.1 against its own eps=0 NLL and the JAX loss at eps=0.1."""
    jm, params, ja, pm, pcfg, pa = _models(copy_impl="scatter",
                                           label_smoothing=0.1)
    jloss, _ = jm.apply(params, ja, deterministic=True)
    t = batch_to_device(pa, "cpu")
    with torch.no_grad():
        smoothed, _ = pm(t)
        pm.cfg = dataclasses.replace(pcfg, label_smoothing=0.0)
        nll, _ = pm(t)
    assert abs(smoothed.item() - nll.item()) > 1e-3
    np.testing.assert_allclose(smoothed.item(), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_five_optimizer_steps_match_optax(accum):
    """Five train steps of the port's Trainer (forward, backward, global
    norm clip, Adam, inverse-sqrt schedule; with accum=2 optax.MultiSteps'
    running mean) against make_train_step with the optax chain, from the
    same init on two alternating batches, warm-up 3 steps and a clip of
    0.5 that every step trips: the losses to 1e-5 relative and every
    final parameter to 5e-4 of the summed learning rates (Adam moves an
    element by at most lr a step, and an element whose gradient is near
    rounding level moves by rounding-sized fractions of lr; a schedule
    off by one step moves the parameters by ~0.1 of it). Adam's epsilon is 1e-6 here, not 1e-9: an element whose
    gradient is zero in exact arithmetic (the decoder's key biases: the
    softmax cancels them) holds rounding noise of ~1e-9 in both packages,
    which an epsilon of 1e-9 would turn into steps of +-lr; they are held
    to 1e-2 of the summed learning rates."""
    jm, params, ja, pm, pcfg, pa = _models(copy_impl="scatter",
                                           label_smoothing=0.1)
    kw = dict(warmup_steps=3, grad_clip=0.5, accum_steps=accum,
              adam_eps=1e-6, weight_decay=0.01 if accum == 1 else 0.0)
    tx = make_optimizer(JaxTrainConfig(**kw), SMALL["d_model"])
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    step = make_train_step(jm, tx)
    half = {k: v.copy() for k, v in ja.items()}
    half["token_mask"] = half["token_mask"].copy()
    half["token_mask"][::2] = False          # a second, different batch
    jbatches = [ja, half]
    pbatches = [batch_to_device(pa, "cpu"),
                dict(batch_to_device(pa, "cpu"),
                     token_mask=torch.from_numpy(half["token_mask"]))]
    trainer = Trainer(pm, pcfg, TrainConfig(**kw), pa, device="cpu")
    jl, pl, norms = [], [], []
    for i in range(5):
        state, jmet = step(state, jbatches[i % 2])
        m = trainer.train_step(pbatches[i % 2])
        jl.append(float(jmet["loss"]))
        pl.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert min(norms) > 0.5                  # the clip is active
    ref = state_dict_from_flax(jax.device_get(state.params))
    lr_sum = sum(trainer.opt.schedule(torch.tensor(c)).item()
                 for c in range(5))
    for name, p in pm.named_parameters():
        atol = lr_sum * (1e-2 if name in ZERO_GRAD else 5e-4)
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def _cli(ckpt, *extra):
    return train_main([
        "--synthetic", "64", "--device", "cpu", "--ckpt_dir", str(ckpt),
        "--d_model", "32", "--d_ff", "64", "--heads", "2",
        "--enc_layers", "2", "--dec_layers", "1", "--max_target_len", "32",
        "--attention_impl", "pallas_local", "--batch_size_tokens", "256",
        "--warmup_steps", "4", "--label_smoothing", "0.1",
        "--prefetch", "1", "--eval_every", "3", "--eval_bleu",
        "--eval_bleu_max", "4", *extra])


def test_cli_trains_and_resumes_bit_identically(tmp_path):
    """`python -m gtos_tpu_torch.train.train --synthetic 64 --device cpu`
    trains (dropout 0.2, the localized attention's plain versions) and
    logs the dev loss and the dev BLEU of a greedy decode every 3 steps
    (c2_amr2.json sets eval_bleu); a run
    cut at step 3 and continued with --resume reaches step 6 with the same
    loss and the same parameters, bit for bit, as the unbroken run: the
    checkpoint carries the optimizer state, the dropout generator's state
    and the loader's cursor (mid-epoch: an epoch has more than 6
    batches). One intra-op thread: MKL's multi-threaded sums on the CPU
    are not reproducible from one call to the next, so two threads give
    different bits even without a resume."""
    torch.set_num_threads(1)
    try:
        _resume_check(tmp_path)
    finally:
        torch.set_num_threads(2)


def _resume_check(tmp_path):
    whole = _cli(tmp_path / "whole", "--total_steps", "6",
                 "--checkpoint_every", "3")
    assert whole["step"] == 6 and np.isfinite(whole["loss"])
    _cli(tmp_path / "cut", "--total_steps", "3", "--checkpoint_every", "3")
    with open(tmp_path / "cut" / "cursor.json") as f:
        # epoch 2: the CLI takes its example batch from epoch 1's plan, as
        # the JAX package's CLI does
        assert json.load(f) == {"epoch": 2, "batch": 3, "step": 3}
    resumed = _cli(tmp_path / "cut", "--total_steps", "6",
                   "--checkpoint_every", "3", "--resume")
    assert resumed["loss"] == whole["loss"]
    for name in ("whole", "cut"):
        assert sorted(os.listdir(tmp_path / name / "step_6")) == [
            "params.pt", "train_state.pt"]
    a = torch.load(tmp_path / "whole" / "step_6" / "params.pt")
    b = torch.load(tmp_path / "cut" / "step_6" / "params.pt")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with open(tmp_path / "whole" / "metrics.jsonl") as f:
        evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
    assert [r["step"] for r in evals] == [3, 6]
    assert all(0.0 <= r["dev_bleu"] <= 100.0 and np.isfinite(r["dev_loss"])
               for r in evals)
    cfg = ModelConfig.from_json(
        (tmp_path / "cut" / "model_config.json").read_text())
    assert (cfg.d_model, cfg.dropout) == (32, 0.2)
    assert TrainConfig.from_json(
        (tmp_path / "cut" / "train_config.json").read_text()).total_steps == 6


def test_dropout_is_active_in_training_only():
    """flax's Dropout: in train mode each element is kept with probability
    1-p and scaled by 1/(1-p), from the model's dropout generator (so a
    reseeded generator repeats the masks); in eval mode, and at rate 0,
    the identity."""
    drop = Dropout(0.25)
    drop.rng = torch.Generator().manual_seed(0)
    x = torch.ones(200, 200)
    y = drop.train()(x)
    assert set(torch.unique(y).tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.01
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)

    g, t = synthetic_amr_corpus(6, seed=3)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    pa = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True,
                  build_local_banks=True).arrays()
    pm = Generator(ModelConfig(**dict(
        SMALL, dropout=0.3, token_vocab=len(tv), concept_vocab=len(cv),
        relation_vocab=len(rv), char_vocab=len(chv),
        attention_impl="pallas_local")), device="cpu")
    t = batch_to_device(pa, "cpu")
    with torch.no_grad():
        e1, e2 = pm.eval()(t)[0], pm(t)[0]
        pm.train()
        pm.dropout_rng.manual_seed(5)
        t1, t2 = pm(t)[0], pm(t)[0]
        pm.dropout_rng.manual_seed(5)
        t3 = pm(t)[0]
    assert e1.item() == e2.item()
    assert t1.item() != t2.item() and t1.item() == t3.item()
    assert t1.item() != e1.item()


def test_corpus_bleu_matches_sacrebleu():
    """utils/bleu.py against sacrebleu.corpus_bleu with its defaults (13a
    tokenizer, exp smoothing): punctuation, digits, a short hypothesis
    (brevity penalty), n-gram orders with no match, and an empty line."""
    import sacrebleu

    refs = ["The boy wants to go to New York, doesn't he?",
            "It costs $3.50 -- or 3,000 yen.",
            "a b c d e f g",
            "the cat sat on the mat",
            "no overlap here at all"]
    cases = [
        refs,
        ["The boy want to go to New-York , doesn't he ?",
         "It costs 3.50$ or 3,000 yen.", "a b c", "the cat the mat", ""],
        ["boy", "It", "g f e d c b a", "on the mat sat the cat", "nothing"],
    ]
    for hyps in cases:
        ref = sacrebleu.corpus_bleu(hyps, [refs]).score
        assert corpus_bleu(hyps, refs) == pytest.approx(ref, abs=1e-9)


def penman(graph) -> str:
    """A Graph as PENMAN text: a depth-first walk from node 0 over its
    out-edges, a variable per node, an edge to a node already written as
    that node's variable."""
    out = {}
    for src, label, tgt in graph.edges:
        out.setdefault(src, []).append((label, tgt))
    seen = set()

    def node(i):
        seen.add(i)
        parts = [f"(n{i} / {graph.nodes[i]}"]
        for label, tgt in out.get(i, []):
            parts.append(f":{label} " + (f"n{tgt}" if tgt in seen
                                         else node(tgt)))
        return " ".join(parts) + ")"

    return node(0)


def write_sembank(path, graphs, targets):
    with open(path, "w") as f:
        for i, (g, t) in enumerate(zip(graphs, targets)):
            f.write(f"# ::id g{i} ::snt {' '.join(t)}\n{penman(g)}\n\n")


def test_train_cli_on_a_sembank_then_work_cli(tmp_path, monkeypatch):
    """The train CLI reads a PENMAN sembank (--train_data, --dev_data)
    under attention_impl "auto" and writes a checkpoint; the work CLI
    rebuilds the model from that directory alone, decodes a test sembank
    and writes one hypothesis per graph in corpus order (checked with a
    decode that answers each graph's own sentence: the output is the
    references, in file order, and BLEU = chrF = 100), and its BLEU and
    chrF of a real decode equal sacrebleu's on the written file."""
    import sacrebleu

    g, t = synthetic_amr_corpus(40, seed=8)
    write_sembank(tmp_path / "train.amr", g[:30], t[:30])
    write_sembank(tmp_path / "test.amr", g[30:], t[30:])
    ckpt = tmp_path / "ckpt"
    last = train_main([
        "--train_data", str(tmp_path / "train.amr"), "--dev_data",
        str(tmp_path / "test.amr"), "--device", "cpu", "--ckpt_dir",
        str(ckpt), "--d_model", "32", "--d_ff", "64", "--heads", "2",
        "--enc_layers", "1", "--dec_layers", "1", "--max_target_len", "32",
        "--attention_impl", "auto", "--batch_size_tokens", "256",
        "--total_steps", "2", "--prefetch", "0"])
    assert last["step"] == 2 and np.isfinite(last["loss"])
    out = tmp_path / "out.txt"
    base = ["--ckpt_dir", str(ckpt), "--test_data",
            str(tmp_path / "test.amr"), "--output", str(out), "--device",
            "cpu", "--beam_size", "2", "--max_time_step", "6",
            "--batch_size_tokens", "64"]
    args = base + ["--eval_bleu", "--eval_chrf"]
    refs = [" ".join(x) for x in t[30:]]

    def answer(model, batch, tv, **kw):
        return [m["snt"].split() for m in batch.meta]

    monkeypatch.setattr("gtos_tpu_torch.infer.decode.decode_batch", answer)
    assert work_main(args) == pytest.approx(100.0)
    assert out.read_text().splitlines() == refs
    monkeypatch.undo()
    bleu = work_main(args)
    hyps = out.read_text().splitlines()
    assert len(hyps) == len(refs)
    assert bleu == pytest.approx(
        sacrebleu.corpus_bleu(hyps, [refs]).score, abs=1e-9)
    chrf = work_main(base + ["--eval_chrf"])     # chrF alone: its score
    assert out.read_text().splitlines() == hyps
    assert chrf == pytest.approx(
        sacrebleu.corpus_chrf(hyps, [refs]).score, abs=1e-9)
    assert corpus_chrf(hyps, refs) == chrf


def test_corpus_chrf_matches_sacrebleu():
    """utils/bleu.py's chrF against sacrebleu.corpus_chrf with its
    defaults (character 6-grams, whitespace removed, beta 2, the
    effective-order average): punctuation, a short and an empty
    hypothesis, and a corpus with no match."""
    import sacrebleu

    refs = ["The boy wants to go to New York, doesn't he?",
            "It costs $3.50 -- or 3,000 yen.", "a b c d e f g",
            "the cat sat on the mat", "no overlap here at all"]
    cases = [refs,
             ["The boy want to go to New-York , doesn't he ?",
              "It costs 3.50$ or 3,000 yen.", "a b c", "the cat the mat",
              ""],
             ["boy", "It", "g f e d c b a", "on the mat sat the cat", "x"],
             ["q"] * 5]
    for hyps in cases:
        ref = sacrebleu.corpus_chrf(hyps, [refs]).score
        assert corpus_chrf(hyps, refs) == pytest.approx(ref, abs=1e-9)
