"""The benchmark of khmer_ocr_torch: see run.py and harness/cli.py."""
