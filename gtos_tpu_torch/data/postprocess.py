"""Hypothesis post-processing: BPE joining, detokenization, anonymized
entity re-attachment.

Port of gtos_tpu/data/postprocess.py. The post-processing the gtos
pipeline applies before BLEU scoring: join BPE pieces, detok,
and re-attach anonymized entities on the AMR side (corpora preprocessed
with anonymization carry placeholders like `person_0` whose surface form
is stored per-instance metadata).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence


def join_bpe(tokens: Sequence[str], marker: str = "@@") -> List[str]:
    """Merge subword pieces produced by learn_bpe-style segmentation:
    pieces ending in the marker glue to the next piece."""
    out: List[str] = []
    buf = ""
    for tok in tokens:
        if tok.endswith(marker):
            buf += tok[: -len(marker)]
        else:
            out.append(buf + tok)
            buf = ""
    if buf:
        out.append(buf)
    return out


_DETOK_NO_SPACE_BEFORE = set(".,!?;:)]}%'’”")
_DETOK_NO_SPACE_AFTER = set("([{$“‘")


def detokenize(tokens: Sequence[str]) -> str:
    """Simple rule-based detokenizer (enough for BLEU-style evaluation;
    swap in an external detokenizer for publication numbers)."""
    out = ""
    for tok in tokens:
        if not out:
            out = tok
        elif tok in _DETOK_NO_SPACE_BEFORE or out[-1] in _DETOK_NO_SPACE_AFTER:
            out += tok
        elif tok.startswith("'") and len(tok) <= 3:  # 's 'll 're n't-ish
            out += tok
        else:
            out += " " + tok
    return out


_ANON_RE = re.compile(r"^([a-z_]+)_(\d+)$")


def reattach_entities(tokens: Sequence[str],
                      mapping: Optional[Dict[str, str]]) -> List[str]:
    """Replace anonymization placeholders (e.g. person_0, date-entity_1)
    with their surface strings from instance metadata; unknown placeholders
    pass through unchanged."""
    if not mapping:
        return list(tokens)
    out: List[str] = []
    for tok in tokens:
        if tok in mapping:
            out.extend(str(mapping[tok]).split())
        else:
            out.append(tok)
    return out


def postprocess_hypothesis(tokens: Sequence[str],
                           entity_map: Optional[Dict[str, str]] = None,
                           bpe_marker: Optional[str] = "@@",
                           detok: bool = False):
    toks = list(tokens)
    if bpe_marker:
        toks = join_bpe(toks, bpe_marker)
    toks = reattach_entities(toks, entity_map)
    return detokenize(toks) if detok else " ".join(toks)
