"""The train CLI's mesh options on the CPU: `--dp 2` and `--graph 2` start
their own gloo ranks (spawned processes), train 2 steps and write one
checkpoint from rank 0; their losses equal the one-device run's on the
same synthetic corpus and seed (rtol 1e-5: the same batches, the loss
over the global token count, gradients summed over the data ranks;
dropout off). With dropout on, a `--dp 2` run stopped at a checkpoint
and resumed trains the uninterrupted run's bits. `--dp 2` on a host with
one card raises naming the count; the JAX package's refusals hold."""

import json
import os

import numpy as np
import pytest
import torch

from gtos_tpu_torch.train.train import main as train_main

torch.set_num_threads(2)
BASE = ["--synthetic", "16", "--device", "cpu", "--d_model", "32",
        "--d_ff", "64", "--heads", "2", "--enc_layers", "1",
        "--dec_layers", "1", "--max_target_len", "32", "--dropout", "0",
        "--total_steps", "2", "--checkpoint_every", "2", "--prefetch", "0"]


def _run(tmp_path, name, flags):
    ckpt = tmp_path / name
    last = train_main(BASE + ["--ckpt_dir", str(ckpt)] + flags)
    return last, ckpt


@pytest.mark.parametrize("flags", [
    ["--dp", "2"],
    ["--graph", "2", "--attention_impl", "sparse", "--sparse_khop", "2"],
    ["--graph", "2", "--attention_impl", "sparse", "--sparse_khop", "2",
     "--cp_schedule", "a2a"],
], ids=["dp2", "graph2-ring", "graph2-a2a"])
def test_mesh_cli_trains_like_one_device(flags, tmp_path):
    """2 steps on a 2-rank mesh: one checkpoint (step_2, the whole
    parameters), one metrics line per log from rank 0, and the losses and
    gradient norm of the one-device run (--dp 0, --graph 1)."""
    impl = flags[flags.index("--attention_impl"):][:4] if \
        "--attention_impl" in flags else []
    ref, _ = _run(tmp_path, "one", impl)
    last, ckpt = _run(tmp_path, "mesh", flags)
    assert last["step"] == 2
    np.testing.assert_allclose(last["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(last["grad_norm"], ref["grad_norm"],
                               rtol=1e-4)
    assert sorted(p for p in os.listdir(ckpt) if p.startswith("step_")) \
        == ["step_2"]
    lines = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text()
             .splitlines()]
    assert [x["step"] for x in lines if x["kind"] == "train"] == [2]
    params = torch.load(ckpt / "step_2" / "params.pt")
    one = torch.load(tmp_path / "one" / "step_2" / "params.pt")
    assert {k: v.shape for k, v in params.items()} == \
        {k: v.shape for k, v in one.items()}


def test_mesh_cli_resume_is_bit_identical(tmp_path):
    """dp=2 with dropout: 2 steps, a checkpoint, --resume to step 4 gives
    the losses and parameters of 4 uninterrupted steps, bit for bit (each
    data rank's dropout generator travels in the checkpoint)."""
    flags = ["--dp", "2", "--dropout", "0.3", "--checkpoint_every", "1"]
    whole, ckpt_a = _run(tmp_path, "whole", flags + ["--total_steps", "4"])
    _run(tmp_path, "cut", flags)
    resumed, ckpt_b = _run(tmp_path, "cut",
                           flags + ["--total_steps", "4", "--resume"])
    assert resumed["step"] == whole["step"] == 4
    assert resumed["loss"] == whole["loss"]
    assert resumed["grad_norm"] == whole["grad_norm"]
    state = torch.load(ckpt_b / "step_4" / "train_state.pt",
                       weights_only=False)
    assert len(state["rng_data"]) == 2
    assert not torch.equal(state["rng_data"][0], state["rng_data"][1])
    a = torch.load(ckpt_a / "step_4" / "params.pt")
    b = torch.load(ckpt_b / "step_4" / "params.pt")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_cli_needs_a_card_per_rank(monkeypatch, tmp_path):
    """On the card, a mesh needs one card a rank on the host: --dp 2 with
    one card visible raises naming the count (no fallback to fewer ranks
    or to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="1 card"):
        train_main(argv + ["--dp", "2", "--ckpt_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "vocabs")


@pytest.mark.parametrize("flags,match", [
    (["--graph", "2"], "edge-partitioned"),
    (["--graph", "2", "--attention_impl", "block_sparse",
      "--cp_schedule", "a2a"], "ring schedule"),
])
def test_mesh_cli_refusals(flags, match, tmp_path):
    """As the JAX package's CLI: --graph needs a sparse impl, and
    block_sparse runs only the ring schedule."""
    with pytest.raises(SystemExit, match=match):
        train_main(BASE + ["--ckpt_dir", str(tmp_path)] + flags)
