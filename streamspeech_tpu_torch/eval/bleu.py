"""Corpus BLEU as sacrebleu 2.6.0's ``corpus_bleu`` computes it at its
defaults, in the port's own code (the card machine has no sacrebleu): the
``13a`` tokenizer (mteval-v13a), ``exp`` smoothing, no lowercasing, no
effective order, n-grams up to 4, the closest reference length for the
brevity penalty. The JAX package's ``SacreBLEUScorer`` (`eval/quality.py:
19-30`) calls sacrebleu itself; every step here follows sacrebleu's own
(`metrics/bleu.py`, `metrics/base.py`, `tokenizers/tokenizer_13a.py`,
`tokenizers/tokenizer_re.py`), in the same order of float operations, so the
scores agree to the last bit."""

from __future__ import annotations

import math
import re
from collections import Counter
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

MAX_NGRAM_ORDER = 4

# mteval-v13a's language-dependent part (Western languages), in order
_13A_RULES = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # period and comma unless preceded by a digit
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    # period and comma unless followed by a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # dash when preceded by a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


@lru_cache(maxsize=2 ** 16)
def tokenize_13a(line: str) -> str:
    """sacrebleu's ``Tokenizer13a``: drop ``<skipped>`` and hyphenated line
    breaks, unescape four HTML entities, split punctuation and symbols off,
    one space between tokens."""
    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = line.replace("&quot;", '"')
        line = line.replace("&amp;", "&")
        line = line.replace("&lt;", "<")
        line = line.replace("&gt;", ">")
    line = f" {line} "
    for pattern, repl in _13A_RULES:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(line: str, max_order: int) -> Tuple[Counter, int]:
    tokens = line.split()
    grams = []
    for n in range(1, max_order + 1):
        for i in range(0, len(tokens) - n + 1):
            grams.append(tuple(tokens[i: i + n]))
    return Counter(grams), len(tokens)


def _closest_ref_len(hyp_len: int, ref_lens: List[int]) -> int:
    closest_diff, closest_len = -1, -1
    for ref_len in ref_lens:
        diff = abs(hyp_len - ref_len)
        if closest_diff == -1 or diff < closest_diff:
            closest_diff, closest_len = diff, ref_len
        elif diff == closest_diff and ref_len < closest_len:
            closest_len = ref_len
    return closest_len


def _log(x: float) -> float:
    """sacrebleu's ``my_log``: log floored at -9999999999 for 0."""
    return -9999999999 if x == 0.0 else math.log(x)


def compute_bleu(correct: List[int], total: List[int], sys_len: int, ref_len: int) -> float:
    """BLEU from its sufficient statistics with ``exp`` smoothing (NIST's,
    mteval-v13a's): an order with no match takes 100 / (2^k · total)."""
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_NGRAM_ORDER
    if not any(correct):
        return 0.0
    smooth = 1.0
    for n in range(1, MAX_NGRAM_ORDER + 1):
        if total[n - 1] == 0:
            break
        if correct[n - 1] == 0:
            smooth *= 2
            precisions[n - 1] = 100.0 / (smooth * total[n - 1])
        else:
            precisions[n - 1] = 100.0 * correct[n - 1] / total[n - 1]
    return bp * math.exp(sum([_log(p) for p in precisions]) / MAX_NGRAM_ORDER)


def corpus_stats(hypotheses: Sequence[str],
                 references: Sequence[Sequence[Optional[str]]]) -> List[int]:
    """[sys_len, ref_len, correct_1..4, total_1..4] summed over the corpus.
    ``references`` is a sequence of reference streams, each parallel to
    ``hypotheses``; a None reference is left out of its segment."""
    if not hypotheses:
        raise ValueError("corpus BLEU of an empty corpus")
    max_order = MAX_NGRAM_ORDER
    stats = [0] * (2 + 2 * max_order)
    for hyp, refs in zip(hypotheses, zip(*references)):
        ref_grams, ref_lens = None, []
        for ref in (r for r in refs if r is not None):
            grams, n = _ngrams(tokenize_13a(ref.rstrip()), max_order)
            ref_lens.append(n)
            if ref_grams is None:
                ref_grams = grams
            else:
                for g, c in grams.items():
                    ref_grams[g] = max(ref_grams[g], c)
        hyp_grams, hyp_len = _ngrams(tokenize_13a(hyp.rstrip()), max_order)
        correct, total = [0] * max_order, [0] * max_order
        for g, c in hyp_grams.items():
            total[len(g) - 1] += c
            if g in ref_grams:
                correct[len(g) - 1] += min(c, ref_grams[g])
        seg = [hyp_len, _closest_ref_len(hyp_len, ref_lens)] + correct + total
        stats = [a + b for a, b in zip(stats, seg)]
    return stats


def corpus_bleu(hypotheses: Sequence[str],
                references: Sequence[Sequence[Optional[str]]]) -> float:
    """``sacrebleu.corpus_bleu(hypotheses, references).score`` at its defaults
    (tokenize ``13a``, smoothing ``exp``, no lowercasing); raises ValueError
    on an empty corpus (sacrebleu raises too)."""
    stats = corpus_stats(hypotheses, references)
    m = MAX_NGRAM_ORDER
    return compute_bleu(stats[2: 2 + m], stats[2 + m:], stats[0], stats[1])
