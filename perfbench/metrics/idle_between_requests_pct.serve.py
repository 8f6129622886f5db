"""Share of a serving window in which the card was idle while the caller was
outside Predictor.predict_batch_tokens (outside the span khmer_ocr.predict:
the strings' decode, the next request's making), in %."""

from perfbench.harness import spans


def read(run):
    if run.trace is None or not run.served:
        return None
    return spans.idle_pct(run.trace, "khmer_ocr.predict", outside=True)
