"""Share of a training window in which the card was idle while the driving
thread waited for the prefetch thread's next batch (the span
khmer_ocr.train.wait_batch in train/loop.py::_prefetched), in %."""

from perfbench.harness import spans


def read(run):
    if run.trace is None or not run.samples:
        return None
    return spans.idle_pct(run.trace, "khmer_ocr.train.wait_batch")
