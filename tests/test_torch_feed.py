"""The training feed's staged copy (gtos_tpu_torch/train/feed.py) on the
CPU: its layout, packed into an ordinary CPU byte buffer and read back as
views, gives every array of a batch as models/generator.py
batch_to_device gives it (keys, dtypes, shapes, values, and so the step's
signature), each at an aligned offset; and a CPU Trainer.fit keeps the
synchronous copy, staging nothing. The copy to the card itself is tested
in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from gtos_tpu_torch.data import DataLoader
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import (
    synthetic_amr_corpus, synthetic_dependency_corpus,
)
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    PAIR_CAP, with_pair_cap,
)
from gtos_tpu_torch.train.feed import ALIGN, layout, pack, unpack
from gtos_tpu_torch.train.train import loader_flags
from gtos_tpu_torch.train.trainer import Trainer
from gtos_tpu_torch.utils import graphs
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

torch.set_num_threads(2)


def _batch(corpus, impl, tokens, **flags):
    g, t = corpus
    dl = DataLoader(preprocess(g, t), *build_vocabs(g, t),
                    batch_size_tokens=tokens, for_train=True,
                    **loader_flags(impl, **flags))
    return next(iter(dl)).arrays()


def _c4():
    """A batch of the c4 translator's loader: dependency trees of 10-50
    tokens, localized banks and the localize sort order."""
    return _batch(synthetic_dependency_corpus(48, seed=2, min_len=10,
                                              max_len=50),
                  "pallas_local", 2048)


def _block_sparse():
    """A block-sparse batch (k-hop 2) with its zero-element pair capacity
    array, as a train step's copy holds it."""
    arrays = with_pair_cap(_batch(synthetic_amr_corpus(8, seed=6),
                                  "block_sparse", 1024, sparse_khop=2))
    assert arrays[PAIR_CAP].size == 0
    return arrays


def _strided():
    """Non-contiguous arrays: a transposed copy, a strided slice, a
    Fortran-ordered mask, and a 0-d scalar."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 100, (12, 9), dtype=np.int32)
    return {"transposed": idx.T.copy().T,
            "strided": rng.standard_normal((8, 10)).astype(np.float32)[:, ::3],
            "fortran": np.asfortranarray(rng.random((5, 7)) > 0.5),
            "scalar": np.array(7, np.int64)}


def _masks():
    """Bool masks of odd sizes between int32 arrays, so that the int32
    arrays' offsets lie past 1-byte-wide arrays."""
    rng = np.random.default_rng(1)
    return {"a": rng.random(3) > 0.5,
            "b": rng.integers(0, 9, (3, 5), dtype=np.int32),
            "c": rng.random((7, 1)) > 0.5,
            "d": rng.integers(0, 9, (2,), dtype=np.int32)}


CASES = {"c4_pallas_local": _c4, "block_sparse": _block_sparse,
         "bool_masks": _masks, "non_contiguous": _strided}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_layout_gives_back_batch_to_device_arrays(case):
    """layout -> pack into a CPU uint8 buffer -> unpack: the keys, dtypes,
    shapes and values of batch_to_device(arrays, "cpu", train=False)
    (the pair capacity already in the batch), the same signature, every
    offset a multiple of ALIGN (itself of 16), and the views contiguous."""
    arrays = CASES[case]()
    plan, size = layout(arrays)
    buf = torch.full((size,), 0xAB, dtype=torch.uint8)
    pack(arrays, plan, buf)
    got = unpack(buf, plan)
    want = batch_to_device(arrays, "cpu", train=False)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
        assert got[k].is_contiguous(), k
    assert graphs.signature(got) == graphs.signature(want)
    assert ALIGN % 16 == 0
    starts = [at for _, at, _, _, _ in plan]
    assert all(at % ALIGN == 0 for at in starts)
    assert all(at + n <= end for (_, at, n, _, _), end in
               zip(plan, starts[1:] + [size]))


def test_cpu_fit_copies_synchronously():
    """A CPU Trainer.fit over a 2-step loader: every step's batch comes
    through the synchronous copy (a plain dict of batch_to_device's
    tensors), and the staged copy counts no batch."""
    g, t = synthetic_dependency_corpus(8, seed=0)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    dl = DataLoader(preprocess(g, t), tv, cv, rv, chv, lm,
                    batch_size_tokens=48, for_train=True,
                    build_local_banks=True)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=16, d_ff=32, heads=2, enc_layers=1,
                      dec_layers=1, char_dim=4, char_filters=8,
                      rel_emb_dim=4, rel_hidden=8, max_oov=8,
                      max_target_len=32, dropout=0.0, use_copy=False,
                      use_node_positions=True,
                      attention_impl="pallas_local")
    model = Generator(cfg, device="cpu",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, TrainConfig(warmup_steps=2, total_steps=2),
                      next(iter(dl)).arrays(), device="cpu")
    seen = []
    step = trainer.train_step

    def spy(arrays):
        seen.append(type(arrays))
        return step(arrays)

    trainer.train_step = spy
    trainer.fit(dl, log_every=1)
    assert trainer.step == 2 and seen == [dict, dict]
    assert trainer.staged_copy.batches == 0
    assert trainer.staged_copy.stream is None
