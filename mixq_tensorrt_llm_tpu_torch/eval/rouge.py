"""Self-contained ROUGE-1/2/L (no external deps). Counterpart of
mixq_tensorrt_llm_tpu/eval/rouge.py, pure Python.

The reference gates accuracy with ROUGE on CNN/DailyMail summaries
(summarize.py:189-197 uses a rouge pip package; threshold check
summarize.py:700-708): the standard recall/precision/F1 ROUGE used there.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence


def _tokens(text: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i: i + n]) for i in range(len(toks) - n + 1))


def _f1(match: int, hyp_total: int, ref_total: int) -> float:
    if hyp_total == 0 or ref_total == 0 or match == 0:
        return 0.0
    p = match / hyp_total
    r = match / ref_total
    return 2 * p * r / (p + r)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_n(hyp: str, ref: str, n: int) -> float:
    h, r = _ngrams(_tokens(hyp), n), _ngrams(_tokens(ref), n)
    match = sum((h & r).values())
    return _f1(match, sum(h.values()), sum(r.values()))


def rouge_l(hyp: str, ref: str) -> float:
    ht, rt = _tokens(hyp), _tokens(ref)
    return _f1(_lcs_len(ht, rt), len(ht), len(rt))


def rouge_scores(hyps: Sequence[str], refs: Sequence[str]
                 ) -> Dict[str, float]:
    """Corpus-average rouge1/rouge2/rougeL F1 (as percentages, like the
    reference's printed numbers)."""
    assert len(hyps) == len(refs) and hyps
    n = len(hyps)
    return {
        "rouge1": 100.0 * sum(rouge_n(h, r, 1) for h, r in zip(hyps, refs)) / n,
        "rouge2": 100.0 * sum(rouge_n(h, r, 2) for h, r in zip(hyps, refs)) / n,
        "rougeL": 100.0 * sum(rouge_l(h, r) for h, r in zip(hyps, refs)) / n,
    }
