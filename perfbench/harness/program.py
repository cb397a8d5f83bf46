"""What the benchmark takes from the program (gtos_tpu_torch): its
readers, vocabularies, preprocessing, loader, model, trainer and search,
through their public entry points, as the train and work CLIs drive them.

The corpus is the benchmark's (traffic/corpora.py), written as the files
a user would give the CLIs; the weights are the benchmark's
(reference/model.py init_weights), made on the card from the seed and
copied into the program's parameters by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from perfbench.reference.model import init_weights, param_spec
from perfbench.traffic import corpora

# the model keys of a configuration file that the program's ModelConfig
# takes as they are
MODEL_KEYS = ("d_model", "d_ff", "heads", "enc_layers", "dec_layers",
              "char_dim", "char_filters", "char_widths", "rel_emb_dim",
              "rel_hidden", "dropout", "label_smoothing", "tie_embeddings",
              "max_oov", "use_copy", "use_node_positions", "compute_dtype",
              "max_target_len", "attention_impl")
TRAIN_KEYS = ("lr_scale", "warmup_steps", "adam_b1", "adam_b2", "adam_eps",
              "weight_decay", "grad_clip", "batch_size_tokens")
# the train CLI's default --seed: the seed of the loader's epoch plan and
# of the dropout stream in every run. The run's seed makes the corpus and
# the weights; with the corpus's sizes fixed too (traffic/corpora.py), the
# plan then groups the same sizes into the same batches for every seed
CLI_SEED = 19940117


@dataclasses.dataclass
class Data:
    """A corpus as the benchmark made it (`corpus`: triples) and as the
    program read it (`graphs`, `targets`)."""

    corpus: List[tuple]
    graphs: list
    targets: list


def read(task: str, corpus, workdir: str, name: str) -> Data:
    """Write `corpus` as the CLI's input files and read them back with
    the program's reader (train/train.py load_corpus)."""
    from gtos_tpu_torch.train.train import load_corpus

    path, tgt = corpora.write_files(task, corpus, workdir, name)
    graphs, targets = load_corpus(task, path, tgt)
    return Data(corpus, graphs, targets)


def vocabularies(data: Data):
    """The CLI's vocabularies of a training corpus (extract.build_vocabs):
    token, concept, relation, char, lexical map."""
    from gtos_tpu_torch.data.extract import build_vocabs

    return build_vocabs(data.graphs, data.targets)


def sizes(config: dict, vocabs) -> dict:
    """The model's sizes: the configuration's, with the vocabulary sizes
    of `vocabs`."""
    tv, cv, rv, chv, _ = vocabs
    return dict(config["model"], token_vocab=len(tv), concept_vocab=len(cv),
                relation_vocab=len(rv), char_vocab=len(chv))


def model_config(cfg: dict):
    from gtos_tpu_torch.utils.config import ModelConfig

    kw = {k: cfg[k] for k in MODEL_KEYS}
    kw["char_widths"] = tuple(kw["char_widths"])
    return ModelConfig(token_vocab=cfg["token_vocab"],
                       concept_vocab=cfg["concept_vocab"],
                       relation_vocab=cfg["relation_vocab"],
                       char_vocab=cfg["char_vocab"], **kw)


def train_config(config: dict):
    from gtos_tpu_torch.utils.config import TrainConfig

    return TrainConfig(seed=CLI_SEED, eval_every=10 ** 12,
                       checkpoint_every=10 ** 12,
                       **{k: config["train"][k] for k in TRAIN_KEYS})


def loader(instances, vocabs, cfg: dict, batch_tokens: int, for_train: bool,
           workers: int = 0, worker_mode: str = "process"):
    """The DataLoader the train CLI (for_train) or the work CLI builds."""
    from gtos_tpu_torch.data.batching import BucketSpec
    from gtos_tpu_torch.data.dataloader import DataLoader
    from gtos_tpu_torch.train.train import loader_flags

    return DataLoader(instances, *vocabs, batch_size_tokens=batch_tokens,
                      for_train=for_train, seed=CLI_SEED,
                      spec=BucketSpec().for_model_max_oov(cfg["max_oov"]),
                      workers=workers, worker_mode=worker_mode,
                      **loader_flags(cfg["attention_impl"]))


def preprocess(data: Data):
    from gtos_tpu_torch.data.dataloader import preprocess as prep

    return prep(data.graphs, data.targets)


def model(cfg: dict, seed: int, device):
    """The program's Generator of `cfg` on `device`, its parameters set to
    the benchmark's weights of `seed` (every name and shape has to be the
    reference's)."""
    from gtos_tpu_torch.models import Generator

    m = Generator(model_config(cfg), device=device,
                  rng=torch.Generator().manual_seed(seed % 2 ** 63))
    weights = init_weights(param_spec(cfg), seed, device)
    own = dict(m.named_parameters())
    want = {k: tuple(v.shape) for k, v in weights.items()}
    have = {k: tuple(v.shape) for k, v in own.items()}
    if want != have:
        raise RuntimeError(
            "the program's parameters are not the reference's: "
            f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    with torch.no_grad():
        for k, v in weights.items():
            own[k].copy_(v)
    return m


def to_device(arrays: Dict, device) -> Dict[str, torch.Tensor]:
    """Numpy arrays as tensors on `device`, for the reference."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
