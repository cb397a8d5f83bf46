"""The port's translator path (the nmt task) against the JAX package on the
CPU: the CoNLL reader, the nmt-shaped model (no copy, node positions,
label smoothing, localized banks) in loss, every gradient and beam search
on dependency batches, and the train and work CLIs on CoNLL files.

The JAX side runs as its own tests run it: "pallas_local_interpret" (the
Pallas kernels under the interpreter); the port runs "pallas_local",
whose wrappers take the plain versions for CPU tensors. Each test states
its tolerance."""

import jax
import numpy as np
import pytest
import torch

from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import (
    synthetic_dependency_corpus as jax_dependency_corpus,
)
from gtos_tpu.graph.dependency import read_conll_file as jax_read_conll_file
from gtos_tpu.infer.decode import beam_decode_arrays as jax_beam_decode
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.data import batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_dependency_corpus
from gtos_tpu_torch.graph import dependency_graph
from gtos_tpu_torch.graph.dependency import read_conll_file
from gtos_tpu_torch.infer.decode import beam_decode_arrays
from gtos_tpu_torch.infer.work import main as work_main
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.train.train import load_corpus
from gtos_tpu_torch.train.train import main as train_main
from gtos_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)

# the nmt model of configs/c4_nmt_ende.json at small widths
NMT = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=2,
           char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
           max_oov=16, max_target_len=64, dropout=0.0, use_copy=False,
           use_node_positions=True, label_smoothing=0.1)


def conll(graph) -> str:
    """A dependency Graph as CoNLL lines `idx token head deprel` (head 0 and
    the label "root" for the token without a head)."""
    heads = {t: (s, lbl) for s, lbl, t in graph.edges}
    rows = []
    for i, tok in enumerate(graph.nodes):
        h, lbl = heads.get(i, (-1, "root"))
        rows.append(f"{i + 1}\t{tok}\t{h + 1}\t{lbl}")
    return "\n".join(rows)


def _same_graphs(jg, pg):
    assert len(jg) == len(pg)
    for a, b in zip(jg, pg):
        assert list(a.nodes) == list(b.nodes)
        assert [tuple(e) for e in a.edges] == [tuple(e) for e in b.edges]
        assert a.meta == b.meta


CONLL_CASES = {
    "tabs": ("1\tThe\t2\tdet\t_\t_\n2\tdog\t3\tnsubj\n3\tbarks\t0\troot\n\n"
             "1\tHi\t0\troot\n\n", 2),
    "spaces": ("1 The 2 det extra cols\n2 dog 3 nsubj\n3 barks 0 root\n\n",
               1),
    # a root in the middle, two roots (a forest), a head after its
    # dependent
    "roots": ("1\ta\t2\tx\n2\tb\t0\troot\n3\tc\t2\ty\n4\td\t0\troot\n\n"
              "1\te\t2\tz\n2\tf\t0\troot\n", 2),
    # no blank line after the last sentence, blank lines between several
    "trailing": ("\n\n1\tone\t0\troot\n\n\n1\ttwo\t2\tamod\n2\tthree\t0\t"
                 "root", 2),
    "empty": ("", 0),
    "short_line": ("1\tThe\t2\n2\tdog\t0\troot\n", "bad CoNLL line"),
    "head_out_of_range": ("1\tThe\t3\tdet\n2\tdog\t0\troot\n",
                          "head 3 out of range for 2 tokens"),
}


@pytest.mark.parametrize("case", sorted(CONLL_CASES))
def test_conll_reader_matches_jax(case, tmp_path):
    """graph/dependency.py's read_conll_file against the JAX package's on a
    file written here: tab- or space-separated columns (extra ones
    ignored), head 0 as the root with no edge, a last sentence without a
    blank line after it; a line of fewer than 4 columns and a head out of
    range raise the same ValueError."""
    text, want = CONLL_CASES[case]
    path = tmp_path / "s.conll"
    path.write_text(text)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want) as je:
            jax_read_conll_file(str(path))
        with pytest.raises(ValueError, match=want) as pe:
            read_conll_file(str(path))
        assert str(pe.value) == str(je.value)
        return
    pg = read_conll_file(str(path))
    assert len(pg) == want
    _same_graphs(jax_read_conll_file(str(path)), pg)
    if case == "tabs":
        assert pg[0].edges == [(1, "det", 0), (2, "nsubj", 1)]
        assert pg[0].nodes == ["The", "dog", "barks"]
    with pytest.raises(ValueError, match="length mismatch"):
        dependency_graph(["a"], [0, 1], ["x"])


def test_synthetic_trees_round_trip_through_conll(tmp_path):
    """conll() of synthetic dependency trees read back gives the same
    graphs in both packages."""
    g, _ = synthetic_dependency_corpus(12, seed=4)
    path = tmp_path / "t.conll"
    path.write_text("\n\n".join(conll(x) for x in g) + "\n")
    back = read_conll_file(str(path))
    assert [x.nodes for x in back] == [x.nodes for x in g]
    assert [x.edges for x in back] == [x.edges for x in g]
    _same_graphs(jax_read_conll_file(str(path)), back)


def _nmt_models(min_len, max_len, for_train):
    """Both packages' nmt-shaped models from one flax init and one
    batchify batch of 6 synthetic dependency trees (local banks; the
    localize sort auxiliaries with for_train)."""
    kw = dict(min_len=min_len, max_len=max_len)
    jg, jt = jax_dependency_corpus(6, seed=3, **kw)
    pg, pt = synthetic_dependency_corpus(6, seed=3, **kw)
    jv = jax_build_vocabs(jg, jt)
    bkw = dict(batch_size_bucket=8, for_train=for_train,
               build_local_banks=True)
    ja = jax_batchify(jax_preprocess(jg, jt), *jv, **bkw).arrays()
    pa = batchify(preprocess(pg, pt), *build_vocabs(pg, pt), **bkw).arrays()
    tv, cv, rv, chv, _ = jv
    cfg = dict(NMT, token_vocab=len(tv), concept_vocab=len(cv),
               relation_vocab=len(rv), char_vocab=len(chv))
    jm = JaxGenerator(JaxModelConfig(
        **cfg, attention_impl="pallas_local_interpret"))
    params = jm.init({"params": jax.random.PRNGKey(0)}, ja,
                     deterministic=True)
    pm = Generator(ModelConfig(**cfg, attention_impl="pallas_local"),
                   device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return jm, params, ja, pm, pa, tv


# node buckets N=16 (the corpus's default lengths, 4-15 tokens) and N=32
# (10-30 tokens)
LENGTHS = {"N16": (4, 15), "N32": (10, 30)}


@pytest.mark.parametrize("size", sorted(LENGTHS))
def test_nmt_loss_and_every_gradient_match_jax(size):
    """The nmt model's teacher-forced loss (no copy: the token softmax
    alone; label smoothing 0.1) and autograd of it against
    jax.value_and_grad of the JAX model on the same training batch: loss
    to 1e-6 relative, acc, n_tok, and every parameter's gradient to
    rtol 1e-5 / atol 1e-7 (f32 sums in another order)."""
    jm, params, ja, pm, pa, _ = _nmt_models(*LENGTHS[size], for_train=True)
    assert ja["concept"].shape[1] == int(size[1:])
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, ja, deterministic=True), has_aux=True))(params)
    pm.train()
    names, ps = zip(*pm.named_parameters())
    assert not any("copy_gate" in n for n in names)
    loss, met = pm(batch_to_device(pa, "cpu"))
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               atol=1e-6)
    assert met["n_tok"].item() == float(jmet["n_tok"])
    ref = state_dict_from_flax(jax.device_get(jgrads))
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        # the decoder's attention key biases: zero in exact arithmetic
        # (the softmax cancels them), rounding noise in both packages
        atol = 1e-6 if name.endswith("k_proj.bias") else 1e-7
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-5,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("size", sorted(LENGTHS))
def test_nmt_beam_decode_token_identical(size, beam):
    """beam_decode_arrays of the nmt model (no copy mass in the search's
    distribution) against the JAX package's search on the same serving
    batch: the same tokens and lengths, scores to 1e-4."""
    jm, params, ja, pm, pa, tv = _nmt_models(*LENGTHS[size],
                                             for_train=False)
    ids = dict(str_id=tv.str_id, end_id=tv.end_id, unk_id=tv.unk_id)
    ref = jax_beam_decode(jm, params, ja, beam_size=beam, max_steps=20,
                          **ids)
    out = beam_decode_arrays(pm, pa, beam_size=beam, max_steps=20, **ids)
    np.testing.assert_array_equal(out.seqs.numpy(), np.asarray(ref.seqs))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-4, atol=1e-4)


def test_load_corpus_nmt_checks_counts(tmp_path):
    """load_corpus("nmt", F.conll, F.tgt): the trees and the whitespace-split
    target lines; counts that differ, or no target file, raise with both
    counts named."""
    g, t = synthetic_dependency_corpus(3, seed=1)
    (tmp_path / "s.conll").write_text("\n\n".join(conll(x) for x in g))
    (tmp_path / "s.tgt").write_text("".join(" ".join(x) + "\n" for x in t))
    graphs, targets = load_corpus("nmt", str(tmp_path / "s.conll"),
                                  str(tmp_path / "s.tgt"))
    assert [x.nodes for x in graphs] == [x.nodes for x in g]
    assert targets == t
    (tmp_path / "s.tgt").write_text("".join(" ".join(x) + "\n"
                                            for x in t[:2]))
    with pytest.raises(SystemExit, match="3 sentences but .* 2 targets"):
        load_corpus("nmt", str(tmp_path / "s.conll"),
                    str(tmp_path / "s.tgt"))
    with pytest.raises(SystemExit, match="target file"):
        load_corpus("nmt", str(tmp_path / "s.conll"))


def _write_pair(prefix, graphs, targets):
    with open(f"{prefix}.conll", "w") as f:
        f.write("\n\n".join(conll(x) for x in graphs) + "\n")
    with open(f"{prefix}.tgt", "w") as f:
        f.writelines(" ".join(x) + "\n" for x in targets)


def _train(tmp_path, name, workers):
    return train_main([
        "--task", "nmt", "--train_data", str(tmp_path / "train.conll"),
        "--train_target", str(tmp_path / "train.tgt"), "--dev_data",
        str(tmp_path / "dev.conll"), "--dev_target",
        str(tmp_path / "dev.tgt"), "--device", "cpu", "--ckpt_dir",
        str(tmp_path / name), "--d_model", "32", "--d_ff", "64", "--heads",
        "2", "--enc_layers", "1", "--dec_layers", "1", "--max_target_len",
        "64", "--attention_impl", "pallas_local", "--batch_size_tokens",
        "128", "--label_smoothing", "0.1", "--total_steps", "3",
        "--prefetch", "1", "--batchify_workers", str(workers)])


def test_nmt_train_cli_then_work_cli(tmp_path, monkeypatch):
    """The train CLI reads CoNLL files with their target files
    (--train_data/--train_target, --dev_data/--dev_target) and trains the
    nmt model (no copy, node positions) on batches from 2 worker processes
    with the same losses and parameters, bit for bit, as without workers
    (one intra-op thread); the work CLI decodes a CoNLL test file with
    --test_target and writes one hypothesis per sentence in file order
    (checked with a decode that answers each sentence's own reference
    from its batch's token_out: the output is the references, in file
    order, and BLEU = 100)."""
    g, t = synthetic_dependency_corpus(30, seed=8, min_len=4, max_len=12)
    _write_pair(tmp_path / "train", g[:24], t[:24])
    _write_pair(tmp_path / "dev", g[24:], t[24:])
    # the test sentences are training ones: every target word is in the
    # token vocab, so token_out spells each reference
    _write_pair(tmp_path / "test", g[5:17], t[5:17])
    torch.set_num_threads(1)
    try:
        runs = [_train(tmp_path, f"ckpt{w}", w) for w in (0, 2)]
    finally:
        torch.set_num_threads(2)
    assert runs[0]["step"] == runs[1]["step"] == 3
    assert runs[0]["loss"] == runs[1]["loss"] and np.isfinite(runs[0]["loss"])
    a = torch.load(tmp_path / "ckpt0" / "step_3" / "params.pt")
    b = torch.load(tmp_path / "ckpt2" / "step_3" / "params.pt")
    assert not any("copy_gate" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    out = tmp_path / "out.txt"
    args = ["--ckpt_dir", str(tmp_path / "ckpt2"), "--task", "nmt",
            "--test_data", str(tmp_path / "test.conll"), "--test_target",
            str(tmp_path / "test.tgt"), "--output", str(out), "--device",
            "cpu", "--beam_size", "2", "--max_time_step", "6",
            "--batch_size_tokens", "64", "--eval_bleu"]
    refs = [" ".join(x) for x in t[5:17]]

    def answer(model, batch, tv, **kw):
        hyps = []
        for row in batch.token_out[: len(batch.meta)]:
            words = []
            for i in row.tolist():
                if i == tv.end_id:
                    break
                words.append(tv.itos[i])
            hyps.append(words)
        return hyps

    monkeypatch.setattr("gtos_tpu_torch.infer.decode.decode_batch", answer)
    assert work_main(args) == pytest.approx(100.0)
    assert out.read_text().splitlines() == refs
    monkeypatch.undo()
    bleu = work_main(args)
    assert len(out.read_text().splitlines()) == len(refs)
    assert 0.0 <= bleu <= 100.0
