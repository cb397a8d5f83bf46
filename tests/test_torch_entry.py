"""The PyTorch port's entry points and package boundary: it imports no JAX
and nothing of the JAX package, its entry points (serving and training)
run on the card unless told otherwise, and its configs load the JAX
package's JSON."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu.utils.config import TrainConfig as JaxTrainConfig
from gtos_tpu_torch.infer.beam import beam_search
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.train.train import main as train_main
from gtos_tpu_torch.train.trainer import Trainer
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(token_vocab=20, concept_vocab=20, relation_vocab=10,
            char_vocab=20, d_model=16, d_ff=32, heads=2, enc_layers=1,
            dec_layers=1, char_dim=4, char_filters=8, rel_emb_dim=4,
            rel_hidden=8, max_oov=8, max_target_len=16, dropout=0.0,
            attention_impl="pallas_local")

# imports every module of the port, serves a small batch on the CPU, and
# prints which of jax / flax / gtos_tpu ended up imported
NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import torch
    torch.set_num_threads(1)
    import gtos_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        gtos_tpu_torch.__path__, "gtos_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.infer.decode import decode_batch
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.utils.config import ModelConfig
    g, t = synthetic_amr_corpus(6, seed=0)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=16, d_ff=32, heads=2, enc_layers=1,
                      dec_layers=1, char_dim=4, char_filters=8,
                      rel_emb_dim=4, rel_hidden=8, max_oov=64,
                      max_target_len=16, dropout=0.0,
                      attention_impl="pallas_local")
    model = Generator(cfg, device="cpu")
    loader = DataLoader(preprocess(g, t), tv, cv, rv, chv, lm,
                        for_train=False, build_local_banks=True)
    hyps = [h for b in loader for h in decode_batch(model, b, tv,
                                                     beam_size=2,
                                                     max_steps=6)]
    from gtos_tpu_torch.data import dataloader
    from gtos_tpu_torch.graph.dependency import dependency_graph
    from gtos_tpu_torch.native import pack_relation_paths_native
    tree = dependency_graph(["a", "b", "c"], [2, 0, 2], ["x", "root", "y"])
    packed = pack_relation_paths_native(tree)
    print(json.dumps({"modules": len(mods), "hyps": len(hyps),
                      "port_modules": sorted(mods),
                      "extractor": dataloader.EXTRACTOR,
                      "tree_paths": len(packed.uniq),
                      "strings": all(isinstance(w, str)
                                     for h in hyps for w in h),
                      "imported": sorted(
                          m for m in sys.modules
                          if m.split(".")[0] in ("jax", "flax", "gtos_tpu")
                          or m.startswith("jaxlib"))}))
""")


# one training step of a small model on the CPU through the Trainer, then
# the same report of imported modules
NO_JAX_TRAIN_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
    g, t = synthetic_amr_corpus(6, seed=0)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=16, d_ff=32, heads=2, enc_layers=1,
                      dec_layers=1, char_dim=4, char_filters=8,
                      rel_emb_dim=4, rel_hidden=8, max_oov=64,
                      max_target_len=16, dropout=0.1,
                      attention_impl="pallas_local")
    batch = next(iter(DataLoader(preprocess(g, t), tv, cv, rv, chv, lm,
                                 build_local_banks=True)))
    model = Generator(cfg, device="cpu")
    trainer = Trainer(model, cfg, TrainConfig(), batch.arrays(),
                      device="cpu")
    m = trainer.train_step(batch_to_device(batch.arrays(), "cpu"))
    print(json.dumps({"loss": m["loss"].item(), "step": trainer.step,
                      "imported": sorted(
                          m for m in sys.modules
                          if m.split(".")[0] in ("jax", "flax", "gtos_tpu")
                          or m.startswith("jaxlib"))}))
""")


def _run_port_script(script):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_decodes_on_the_cpu():
    """In a fresh interpreter (this one has JAX: conftest imports it):
    every gtos_tpu_torch module imports (the native extractor's binding
    and the CoNLL reader among them), a CPU decode runs on instances from
    the native extractor, a dependency tree goes through it, and neither
    jax, flax nor gtos_tpu is in sys.modules afterwards."""
    report = _run_port_script(NO_JAX_SCRIPT)
    assert report["modules"] >= 20
    assert {"gtos_tpu_torch.native", "gtos_tpu_torch.graph.dependency",
            "gtos_tpu_torch.parallel.ring_block_sparse",
            "gtos_tpu_torch.parallel.mesh"} <= set(report["port_modules"])
    assert report["extractor"] == "native"
    # NONE, the six paths of the 3-token tree's off-diagonal pairs, SELF
    assert report["tree_paths"] == 8
    assert report["hyps"] == 6 and report["strings"]
    assert report["imported"] == []


# a world of one gloo rank in a fresh interpreter: the mesh, each rank's
# part of a batch, a sharded train step under "block_sparse" (tensor and
# data parallel code paths on one rank), and the emulated CP schedules
NO_JAX_MESH_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.parallel import ring_attention, ring_block_sparse
    from gtos_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, shard_arrays)
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
    init_distributed(0, 1, "file://" + os.path.join(tempfile.mkdtemp(),
                                                     "rdv"), "cpu")
    mesh = make_mesh(dp=1, mp=1, graph=1, device="cpu")
    g, t = synthetic_amr_corpus(6, seed=0)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=16, d_ff=32, heads=2, enc_layers=1,
                      dec_layers=1, char_dim=4, char_filters=8,
                      rel_emb_dim=4, rel_hidden=8, max_oov=64,
                      max_target_len=16, dropout=0.1, sparse_khop=2,
                      attention_impl="block_sparse")
    batch = next(iter(DataLoader(preprocess(g, t), tv, cv, rv, chv, lm,
                                 build_edges=True, build_block_tiles=True,
                                 sparse_khop=2)))
    trainer = Trainer(Generator(cfg, device="cpu"), cfg, TrainConfig(),
                      batch.arrays(), mesh=mesh, device="cpu")
    m = trainer.train_step(shard_arrays(mesh, batch.arrays()))
    q = torch.randn(1, 2, 256, 8)
    cells = [torch.zeros(1, 2, 2, 4, dtype=torch.int32) for _ in range(3)]
    out = ring_attention.emulate_ring(
        q, q, q, torch.zeros(4, 2, 8), torch.zeros(4, 2, 8), *cells,
        torch.ones(1, 2, 2, 4, dtype=torch.bool), 2)
    dist.destroy_process_group()
    print(json.dumps({"loss": m["loss"].item(), "step": trainer.step,
                      "out": list(out.shape),
                      "imported": sorted(
                          m for m in sys.modules
                          if m.split(".")[0] in ("jax", "flax", "gtos_tpu")
                          or m.startswith("jaxlib"))}))
""")


def test_mesh_tier_imports_no_jax():
    """In a fresh interpreter, the multi-device tier (a one-rank gloo mesh,
    shard_arrays, a sharded "block_sparse" train step, an emulated ring)
    runs and leaves jax, flax and gtos_tpu out of sys.modules."""
    report = _run_port_script(NO_JAX_MESH_SCRIPT)
    assert report["step"] == 1 and report["loss"] > 0
    assert report["out"] == [1, 2, 256, 8]
    assert report["imported"] == []


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without a visible card, an entry point called without device=
    raises: it never carries on quietly on the CPU. device="cpu" works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(ModelConfig(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beam_search(lambda *a: None, [], 1, 1, 1, 4, 4, 2, 3, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(ModelConfig(**TINY), device="cuda")
    model = Generator(ModelConfig(**TINY), device="cpu")
    assert model.device == torch.device("cpu")


def test_port_trains_on_the_cpu_without_jax():
    """In a fresh interpreter, a train step on the CPU (forward, the
    localized attention's plain backward, clip, Adam) leaves jax, flax and
    gtos_tpu out of sys.modules."""
    report = _run_port_script(NO_JAX_TRAIN_SCRIPT)
    assert report["step"] == 1 and report["loss"] > 0
    assert report["imported"] == []


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Without a visible card, the Trainer and the train CLI called without
    a device raise before any work; given the CPU they run (the CLI test in
    tests/test_torch_train.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Generator(ModelConfig(**TINY), device="cpu")
    arrays = {"token_out": np.zeros((1, 4), np.int32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, model.cfg, TrainConfig(), arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, model.cfg, TrainConfig(), arrays, device="cuda")
    assert Trainer(model, model.cfg, TrainConfig(), arrays,
                   device="cpu").step == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--synthetic", "8", "--ckpt_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,item", [
    # ported since (ROADMAP A9): 2 data-parallel ranks, 2 graph ranks of
    # the edge-cell ring (spawned gloo processes); --coordinator without a
    # mesh is not used, as in the JAX package's CLI on one host (ids kept)
    pytest.param(["--dp", "2"], None, id="flags0-A9"),
    pytest.param(["--graph", "2", "--attention_impl", "sparse"], None,
                 id="flags1-A9"),
    pytest.param(["--coordinator", "localhost:1234"], None, id="flags2-A9"),
    # ported since (ROADMAP A7): these train
    pytest.param(["--attention_impl", "auto"], None, id="flags3-A7"),
    pytest.param(["--attention_impl", "pallas"], None, id="flags4-A7"),
    # ported since (ROADMAP A8): these train, the second over 2-hop pairs
    pytest.param(["--attention_impl", "sparse"], None, id="flags5-A8"),
    pytest.param(["--attention_impl", "block_sparse", "--sparse_khop", "2"],
                 None, id="flags6-A8"),
])
def test_train_cli_refuses_unported_options(flags, item, tmp_path):
    """The train CLI's options whose feature is not ported raise and name
    the ROADMAP item that ports it, before any work; the options ported
    since (item None: the mesh options, "auto", "pallas", "sparse" and
    "block_sparse") train a step on the CPU."""
    argv = ["--synthetic", "8", "--device", "cpu", "--ckpt_dir",
            str(tmp_path), *flags]
    if item is None:
        last = train_main(argv + [
            "--d_model", "16", "--d_ff", "32", "--heads", "2",
            "--enc_layers", "1", "--dec_layers", "1", "--max_target_len",
            "16", "--total_steps", "1", "--prefetch", "0"])
        assert last["step"] == 1 and np.isfinite(last["loss"])
        cfg = ModelConfig.from_json(
            (tmp_path / "model_config.json").read_text())
        if "--attention_impl" in flags:
            impl = flags[flags.index("--attention_impl") + 1]
            assert cfg.attention_impl == impl
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_main(argv)


def test_train_config_json_loads_in_both_packages():
    """One train_config.json loads in both packages, field for field."""
    names = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert names == {f.name for f in dataclasses.fields(TrainConfig)}
    jcfg = JaxTrainConfig(warmup_steps=7, accum_steps=2, weight_decay=0.1)
    pcfg = TrainConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(JaxTrainConfig.from_json(pcfg.to_json())) == \
        dataclasses.asdict(jcfg)
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())


def test_model_config_json_loads_in_both_packages():
    """One model_config.json loads in both packages, field for field."""
    with open(os.path.join(ROOT, "configs", "c2_amr2.json")) as f:
        conf = json.load(f)
    names = {f.name for f in dataclasses.fields(JaxModelConfig)}
    assert names == {f.name for f in dataclasses.fields(ModelConfig)}
    jcfg = JaxModelConfig(**{k: v for k, v in conf.items() if k in names},
                          token_vocab=7)
    pcfg = ModelConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(JaxModelConfig.from_json(pcfg.to_json())) == \
        dataclasses.asdict(jcfg)
    assert (pcfg.d_model, pcfg.heads, pcfg.attention_impl,
            pcfg.compute_dtype) == (512, 8, "pallas_local", "bfloat16")


@pytest.mark.parametrize("impl", ["pallas", "auto", "sparse",
                                  "block_sparse"])
def test_unported_attention_impls_raise(impl):
    """Every attention impl of the JAX package is ported now ("pallas" and
    "auto" since ROADMAP A7, the sparse ones since A8) and builds, with a
    context-parallel mesh too (A9): every encoder layer holds it."""
    cfg = ModelConfig(**dict(TINY, attention_impl=impl))
    assert Generator(cfg, device="cpu").cfg.attention_impl == impl
    mesh = object()
    gt = Generator(cfg, device="cpu", cp_mesh=mesh).graph_transformer
    assert gt.cp_mesh is mesh and gt.layer0.self_attn.cp_mesh is mesh


@pytest.mark.parametrize("impl", ["pallas_interpret", "auto_interpret",
                                  "pallas_local_interpret",
                                  "block_sparse_interpret"])
def test_interpret_impls_raise_value_error(impl):
    """The port has no interpret mode: the JAX package's "*_interpret"
    impls raise ValueError naming the impl to use (CPU tensors run the
    plain versions)."""
    with pytest.raises(ValueError, match="no interpret mode"):
        Generator(ModelConfig(**dict(TINY, attention_impl=impl)),
                  device="cpu")


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_global_bank_train_step_imports_no_jax(impl):
    """In a fresh interpreter, a train step on the CPU under "pallas" (the
    global-bank forward and backward's plain versions) or "auto" leaves
    jax, flax and gtos_tpu out of sys.modules."""
    script = NO_JAX_TRAIN_SCRIPT.replace(
        'attention_impl="pallas_local"', f'attention_impl="{impl}"').replace(
        "build_local_banks=True", 'build_local_banks="auto"')
    assert f'"{impl}"' in script
    report = _run_port_script(script)
    assert report["step"] == 1 and report["loss"] > 0
    assert report["imported"] == []


def test_block_sparse_train_step_imports_no_jax():
    """In a fresh interpreter, a train step on the CPU under
    "block_sparse" (edge cells and tiles at sparse_khop 2; the plain
    versions of B5s and B6) leaves jax, flax and gtos_tpu out of
    sys.modules."""
    script = NO_JAX_TRAIN_SCRIPT.replace(
        'attention_impl="pallas_local"', 'attention_impl="block_sparse"'
    ).replace("build_local_banks=True", "build_edges=True, "
              "build_block_tiles=True, sparse_khop=2")
    assert "sparse_khop=2" in script and '"block_sparse"' in script
    report = _run_port_script(script)
    assert report["step"] == 1 and report["loss"] > 0
    assert report["imported"] == []
