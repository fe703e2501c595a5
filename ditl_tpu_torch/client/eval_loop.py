"""Process-0 API evaluation loop: a copy of the JAX package's
``client/eval_loop.py``.

The trainer calls ``run_api_eval`` between steps with a handful of
examples: the coordinator sends them to the remote model concurrently
(``LLMClient.complete_many``), logs prompt, response and label, and scores
the replies as a sentiment classifier's; every other process returns at
once.
"""

from __future__ import annotations

from ditl_tpu_torch.client.llm import ERROR_SENTINEL, LLMClient
from ditl_tpu_torch.runtime.distributed import is_coordinator
from ditl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["run_api_eval"]

_SYSTEM = (
    "You are a sentiment classifier. Reply with exactly one word: "
    "'positive' or 'negative'."
)


def run_api_eval(
    client: LLMClient,
    texts: list[str],
    labels: list[int],
    max_samples: int = 8,
    log_chars: int = 100,
) -> dict:
    """Send up to ``max_samples`` texts to the remote model; log and score.

    Runs only on the coordinator (every other process returns at once).
    Returns {'n', 'n_errors', 'accuracy'} (accuracy over non-error replies).
    """
    if not is_coordinator():
        return {"n": 0, "n_errors": 0, "accuracy": 0.0}
    texts = texts[:max_samples]
    labels = labels[:max_samples]
    responses = client.complete_many(texts, system=_SYSTEM)
    n_errors = 0
    n_correct = 0
    n_scored = 0
    for text, label, response in zip(texts, labels, responses):
        logger.info("Prompt: %s...", text[:log_chars])
        logger.info("Response: %s...", response[:log_chars])
        logger.info("Actual label: %d", label)
        if response == ERROR_SENTINEL:
            n_errors += 1
            continue
        lowered = response.lower()
        predicted = 1 if "positive" in lowered else 0 if "negative" in lowered else None
        if predicted is not None:
            n_scored += 1
            n_correct += int(predicted == label)
    accuracy = n_correct / n_scored if n_scored else 0.0
    logger.info(
        "api eval: %d samples, %d errors, accuracy %.3f", len(texts), n_errors, accuracy
    )
    return {"n": len(texts), "n_errors": n_errors, "accuracy": accuracy}
