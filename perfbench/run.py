"""Entry point of the benchmark of ``khmer_ocr_torch``: see harness/cli.py.

Run from the root of a checkout:

    python3 perfbench/run.py --workload serve_se_vgg_beam3_pages --seed 1 --seconds 20 --trace 0

Every cache the program builds stays inside the checkout at a fixed path:
the CUDA kernels in ``khmer_ocr_torch/_build/`` (the program's own), and
torch's extension and Triton caches under ``perfbench/_cache/``.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "perfbench" / "_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "perfbench" / "_cache" / "triton"))
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.cli import main

    sys.exit(main(sys.argv[1:], ROOT))
