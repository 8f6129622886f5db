"""Character tokenizer over the bundled 124-entry vocabulary.

<pad>=0, <unk>=1, <sos>=2, <eos>=3, then ASCII and Khmer code points.
``decode`` skips <sos>/<pad> and stops at <eos>.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_DEFAULT_VOCAB = Path(__file__).resolve().parent / "assets" / "char2idx.json"


class Tokenizer:
    def __init__(self, char2idx_path: str | Path | None = None):
        path = Path(char2idx_path) if char2idx_path else _DEFAULT_VOCAB
        if not path.exists():
            raise FileNotFoundError(f"Vocab file not found: {path}")
        with open(path, "r", encoding="utf-8") as f:
            self.char2idx: dict[str, int] = json.load(f)
        self.idx2char = {v: k for k, v in self.char2idx.items()}
        self.sos_idx = self.char2idx.get("<sos>", 1)
        self.eos_idx = self.char2idx.get("<eos>", 2)
        self.pad_idx = self.char2idx.get("<pad>", 0)

    def decode(self, token_ids) -> str:
        """Ids -> string: skip <sos>/<pad>, stop at <eos>, unknown ids -> ''."""
        result = []
        for idx in np.asarray(token_ids).tolist():
            idx = int(idx)
            if idx == self.sos_idx or idx == self.pad_idx:
                continue
            if idx == self.eos_idx:
                break
            result.append(self.idx2char.get(idx, ""))
        return "".join(result)
