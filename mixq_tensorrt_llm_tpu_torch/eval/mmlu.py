"""MMLU-style multiple-choice evaluation. Counterpart of
mixq_tensorrt_llm_tpu/eval/mmlu.py.

Few-shot prompts over the standard MMLU csv layout (question, A, B, C, D,
answer) in a local ``data_dir`` of ``<subject>_test.csv`` files (and
optional ``<subject>_dev.csv`` for the shots). Scoring, as the reference's:
the next-token logits over the four choice letters at the end of the
prompt, one prefill per question.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

CHOICES = ("A", "B", "C", "D")


def format_example(row: List[str], include_answer: bool) -> str:
    q, a, b, c, d = row[0], row[1], row[2], row[3], row[4]
    s = (f"{q.strip()}\n"
         f"A. {a.strip()}\nB. {b.strip()}\nC. {c.strip()}\nD. {d.strip()}\n"
         f"Answer:")
    if include_answer:
        s += f" {row[5].strip()}\n\n"
    return s


def build_prompt(dev_rows: List[List[str]], test_row: List[str],
                 subject: str, k_shot: int) -> str:
    header = (f"The following are multiple choice questions (with answers) "
              f"about {subject.replace('_', ' ')}.\n\n")
    shots = "".join(format_example(r, True) for r in dev_rows[:k_shot])
    return header + shots + format_example(test_row, False)


def _read_csv(path: str) -> List[List[str]]:
    with open(path, newline="") as f:
        return [row for row in csv.reader(f) if row]


def evaluate_mmlu(llm, data_dir: str, k_shot: int = 5,
                  max_questions_per_subject: Optional[int] = None,
                  max_input_len: int = 2048) -> Dict[str, float]:
    """Accuracy per subject and 'average'. llm: an ``api.LLM``."""
    tok = llm.tokenizer
    choice_ids = [tok(f" {c}", add_special_tokens=False)["input_ids"][-1]
                  for c in CHOICES]
    results: Dict[str, Tuple[int, int]] = {}

    for test_file in sorted(glob.glob(os.path.join(data_dir, "*_test.csv"))):
        subject = os.path.basename(test_file)[: -len("_test.csv")]
        dev_file = os.path.join(data_dir, f"{subject}_dev.csv")
        dev_rows = _read_csv(dev_file) if os.path.exists(dev_file) else []
        rows = _read_csv(test_file)
        if max_questions_per_subject:
            rows = rows[:max_questions_per_subject]

        correct = 0
        for row in rows:
            prompt = build_prompt(dev_rows, row, subject, k_shot)
            ids = tok(prompt)["input_ids"][-max_input_len:]
            n = len(ids)
            padded = 1 << (n - 1).bit_length()   # pow2 buckets, as JAX's
            tokens = np.zeros((1, padded), np.int32)
            tokens[0, :n] = ids
            logits = llm.session.score_logits(tokens, np.asarray([n]))
            last = logits[0, n - 1, choice_ids].float().cpu().numpy()
            if CHOICES[int(np.argmax(last))] == row[5].strip().upper():
                correct += 1
        results[subject] = (correct, len(rows))

    out = {s: c / t for s, (c, t) in results.items() if t}
    total_c = sum(c for c, _ in results.values())
    total_t = sum(t for _, t in results.values())
    out["average"] = total_c / total_t if total_t else 0.0
    return out
