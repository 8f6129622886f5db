"""Share of a serving window in which the card was idle while the caller was
inside a batch's decode (the span khmer_ocr.decode of
Predictor._decode_dispatched: the graphs' replays, the exit tests' syncs
between them, the tokens' copy start), in %."""

from perfbench.harness import spans


def read(run):
    if run.trace is None or not run.served:
        return None
    return spans.idle_pct(run.trace, "khmer_ocr.decode")
