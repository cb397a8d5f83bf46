"""Corpus BLEU and chrF, as `sacrebleu.corpus_bleu(hyps, [refs]).score`
and `sacrebleu.corpus_chrf(hyps, [refs]).score` compute them with their
defaults (BLEU: 13a tokenizer, exp smoothing, 4-grams; chrF: character
6-grams without whitespace, beta 2, the effective-order average), one
reference per hypothesis, for the dev-BLEU hook of training and the
work.py CLI: the machine with the card has no sacrebleu.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Sequence

MAX_ORDER = 4
_13A = [
    # punctuation and symbols become tokens
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # period and comma, unless preceded by a digit
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    # period and comma, unless followed by a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # dash after a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def tokenize_13a(line: str) -> str:
    """mteval-v13a's tokenization, as sacrebleu's default tokenizer."""
    line = line.replace("<skipped>", "").replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                .replace("&lt;", "<").replace("&gt;", ">"))
    line = f" {line} "
    for pattern, repl in _13A:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(tokens: List[str]) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for n in range(1, MAX_ORDER + 1)
                   for i in range(len(tokens) - n + 1))


def bleu_stats(hyps: Sequence[str], refs: Sequence[str]) -> List[int]:
    """BLEU's sufficient statistics, which add over parts of a corpus:
    correct and total n-grams for n = 1..4, then the hypothesis and
    reference lengths (10 ints)."""
    correct = [0] * MAX_ORDER
    total = [0] * MAX_ORDER
    sys_len = ref_len = 0
    for hyp, ref in zip(hyps, refs):
        h = tokenize_13a(hyp.rstrip()).split()
        r = tokenize_13a(ref.rstrip()).split()
        sys_len += len(h)
        ref_len += len(r)
        ref_counts = _ngrams(r)
        for gram, count in _ngrams(h).items():
            total[len(gram) - 1] += count
            correct[len(gram) - 1] += min(count, ref_counts.get(gram, 0))
    return correct + total + [sys_len, ref_len]


def corpus_bleu(hyps: Sequence[str], refs: Sequence[str]) -> float:
    """BLEU (0-100) of hypothesis strings against one reference string
    each."""
    return bleu_from_stats(bleu_stats(hyps, refs))


def bleu_from_stats(stats: Sequence[int]) -> float:
    """BLEU (0-100) from bleu_stats (summed over parts of a corpus)."""
    correct = list(stats[:MAX_ORDER])
    total = list(stats[MAX_ORDER:2 * MAX_ORDER])
    sys_len, ref_len = stats[2 * MAX_ORDER:]
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    if not any(correct):
        return 0.0
    precisions = [0.0] * MAX_ORDER
    smooth = 1.0
    for n in range(MAX_ORDER):
        if total[n] == 0:
            break
        if correct[n] == 0:
            smooth *= 2
            precisions[n] = 100.0 / (smooth * total[n])
        else:
            precisions[n] = 100.0 * correct[n] / total[n]
    logs = [math.log(p) if p > 0 else -9999999999 for p in precisions]
    return bp * math.exp(sum(logs) / MAX_ORDER)


CHRF_ORDER, CHRF_BETA = 6, 2


def corpus_chrf(hyps: Sequence[str], refs: Sequence[str]) -> float:
    """chrF (0-100) of hypothesis strings against one reference string
    each: character n-gram (n = 1..6, whitespace removed) counts summed
    over the corpus, then the F-beta of the precision and recall averaged
    over the orders that both sides have."""
    stats = [[0, 0, 0] for _ in range(CHRF_ORDER)]  # hyp, ref, match
    for hyp, ref in zip(hyps, refs):
        h, r = "".join(hyp.split()), "".join(ref.split())
        for n in range(1, CHRF_ORDER + 1):
            hc = Counter(h[i:i + n] for i in range(len(h) - n + 1))
            rc = Counter(r[i:i + n] for i in range(len(r) - n + 1))
            st = stats[n - 1]
            st[0] += sum(hc.values()) if rc else 0
            st[1] += sum(rc.values())
            st[2] += sum(min(c, rc[g]) for g, c in hc.items() if g in rc)
    factor = CHRF_BETA ** 2
    prec = rec = 0.0
    orders = 0
    for n_hyp, n_ref, n_match in stats:
        if n_hyp > 0 and n_ref > 0:
            prec += n_match / n_hyp
            rec += n_match / n_ref
            orders += 1
    if orders:
        prec, rec = prec / orders, rec / orders
    if prec + rec == 0:
        return 0.0
    return 100 * (1 + factor) * prec * rec / (factor * prec + rec)
