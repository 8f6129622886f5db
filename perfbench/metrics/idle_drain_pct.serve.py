"""Share of a serving window in which the card was idle while the caller
drained a batch (the span khmer_ocr.drain of Predictor._drain: the wait on
the tokens' copy and the scatter of rows), in %."""

from perfbench.harness import spans


def read(run):
    if run.trace is None or not run.served:
        return None
    return spans.idle_pct(run.trace, "khmer_ocr.drain")
