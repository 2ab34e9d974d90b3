from .ppl import evaluate_ppl, tokenize_corpus, PPLResult  # noqa: F401
from .rouge import rouge_scores  # noqa: F401
