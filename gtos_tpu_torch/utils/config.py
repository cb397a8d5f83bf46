"""Typed, JSON-serializable configs — field for field the JAX package's
`gtos_tpu.utils.config.ModelConfig` and `TrainConfig`, so one
`model_config.json` / `train_config.json` loads in both packages."""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # vocab sizes (filled from the extracted vocabs)
    token_vocab: int = 0
    concept_vocab: int = 0
    relation_vocab: int = 0
    char_vocab: int = 0
    # architecture (the reference's scale: d=512, ff=1024, 8 heads)
    d_model: int = 512
    d_ff: int = 1024
    heads: int = 8
    enc_layers: int = 4
    dec_layers: int = 4
    # char CNN token encoder
    char_dim: int = 32
    char_filters: int = 128
    char_widths: Tuple[int, ...] = (3,)
    # relation path GRU encoder
    rel_emb_dim: int = 64
    rel_hidden: int = 128
    # regularization / output
    dropout: float = 0.2
    label_smoothing: float = 0.0
    tie_embeddings: bool = True
    # copy mechanism: extended vocab = token_vocab + max_oov
    max_oov: int = 64
    use_copy: bool = True
    # "onehot" | "scatter": how the JAX package lands the copy mass on the
    # extended vocab. Both compute the same function; the port uses one
    # f32 scatter-add for either value (models/generator.py)
    copy_impl: str = "onehot"
    # translator path: nodes are source words in order -> add positions
    use_node_positions: bool = False
    # numerics: activations in compute_dtype ("float32" | "bfloat16")
    compute_dtype: str = "float32"
    max_target_len: int = 128
    # encoder attention implementation: every value of the JAX package
    # (models/graph_transformer.py); "*_interpret" raises (no interpret
    # mode in the port)
    attention_impl: str = "xla"
    sparse_khop: int = 0
    # "sparse" under a context-parallel mesh: "ring" or "a2a"
    cp_schedule: str = "ring"

    @property
    def ext_vocab(self) -> int:
        return self.token_vocab + self.max_oov

    @property
    def head_dim(self) -> int:
        if self.d_model % self.heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"heads {self.heads}")
        return self.d_model // self.heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        d = json.loads(s)
        if "char_widths" in d:
            d["char_widths"] = tuple(d["char_widths"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # optimizer: Adam + inverse-sqrt warmup (the transformer schedule)
    lr_scale: float = 1.0
    warmup_steps: int = 4000
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    accum_steps: int = 1
    # loop
    total_steps: int = 10000
    eval_every: int = 500
    checkpoint_every: int = 1000
    batch_size_tokens: int = 4096
    seed: int = 19940117
    # the data-parallel width of the run (the CLI's --dp; 0: no mesh)
    dp_size: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls(**json.loads(s))
