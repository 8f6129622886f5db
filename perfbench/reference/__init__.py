"""The plain PyTorch reference the benchmark judges the program against.

It imports nothing of khmer_ocr_torch and takes nothing the program made."""
