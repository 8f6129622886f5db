"""Share of a serving window in which the card was idle while the caller
waited for the dispatch stage's next batch (the span khmer_ocr.wait_dispatch
around the queue's get in Predictor.predict_batch_tokens), in %."""

from perfbench.harness import spans


def read(run):
    if run.trace is None or not run.served:
        return None
    return spans.idle_pct(run.trace, "khmer_ocr.wait_dispatch")
