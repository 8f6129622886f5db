"""Evaluation metrics: Levenshtein distance, CER, and the folder-pair Evaluator.

``cer = distance / len(ref)``, with the edge cases 0.0 when both strings are
empty and 1.0 when the reference is empty and the hypothesis is not.
``Evaluator`` walks ``<root>/{images,labels}`` folder pairs, averages the
per-line CER and reports exact-match accuracy and the lines above a failure
threshold. ``score`` does the scoring of (names, references, hypotheses)
held in memory, with the batched C++ distance (native/levenshtein.cpp).
``levenshtein`` is the numpy row DP, one pair at a time.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".webp"}


def levenshtein(ref: str, hyp: str) -> int:
    """Edit distance (insert/delete/substitute, all cost 1)."""
    if ref == hyp:
        return 0
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    r = np.frombuffer(ref.encode("utf-32-le"), dtype=np.uint32)
    h = np.frombuffer(hyp.encode("utf-32-le"), dtype=np.uint32)
    # prev[j] = D(i-1, j): substitution and deletion are elementwise, the
    # insertion term a running-minimum scan
    prev = np.arange(h.size + 1, dtype=np.int64)
    for i in range(1, r.size + 1):
        sub = prev[:-1] + (h != r[i - 1])
        cur = np.empty_like(prev)
        cur[0] = i
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        np.minimum.accumulate(cur + np.arange(cur.size, 0, -1), out=cur)
        cur -= np.arange(cur.size, 0, -1)
        prev = cur
    return int(prev[-1])


def calculate_cer(reference: str, hypothesis: str) -> float:
    """Character error rate = edit_distance / len(reference)."""
    if len(reference) == 0:
        return 0.0 if len(hypothesis) == 0 else 1.0
    return levenshtein(reference, hypothesis) / len(reference)


@dataclasses.dataclass
class EvalResult:
    mean_cer: float
    exact_match_accuracy: float
    num_samples: int
    failures: list[tuple[str, str, str, float]]  # (name, ref, hyp, cer)

    def summary(self) -> str:
        return (
            f"samples={self.num_samples} mean_cer={self.mean_cer:.4%} "
            f"exact_match={self.exact_match_accuracy:.4%}"
        )


def score(names: list[str], refs: list[str], hyps: list[str], failure_threshold: float = 0.10) -> EvalResult:
    """Mean per-line CER, exact-match share and the lines whose CER exceeds
    ``failure_threshold``, with the distances from the C++ kernel."""
    from .native import levenshtein_batch

    distances = levenshtein_batch(refs, hyps)
    cers, failures, exact = [], [], 0
    for name, ref, hyp, dist in zip(names, refs, hyps, distances):
        if len(ref) == 0:
            cer = 0.0 if len(hyp) == 0 else 1.0
        else:
            cer = float(dist) / len(ref)
        cers.append(cer)
        exact += int(ref == hyp)
        if cer > failure_threshold:
            failures.append((name, ref, hyp, cer))
    return EvalResult(
        mean_cer=float(np.mean(cers)) if cers else 0.0,
        exact_match_accuracy=exact / len(names) if names else 0.0,
        num_samples=len(names),
        failures=failures,
    )


class Evaluator:
    """CER harness over ``<root>/{images,labels}`` folder pairs.

    ``recognize_fn`` maps a list of image paths to a list of strings, so that
    recognition runs batched end to end."""

    def __init__(self, recognize_fn, failure_threshold: float = 0.10):
        self.recognize_fn = recognize_fn
        self.failure_threshold = failure_threshold

    @staticmethod
    def _pairs(split_dir: str | Path) -> list[tuple[Path, Path]]:
        split_dir = Path(split_dir)
        img_dir, lab_dir = split_dir / "images", split_dir / "labels"
        if not img_dir.is_dir() or not lab_dir.is_dir():
            raise FileNotFoundError(f"Expected {split_dir}/images and {split_dir}/labels")
        pairs = []
        for img in sorted(img_dir.iterdir()):
            if img.suffix.lower() not in IMG_EXTS:
                continue
            lab = lab_dir / (img.stem + ".txt")
            if lab.exists():
                pairs.append((img, lab))
        return pairs

    def evaluate_split(self, split_dir: str | Path, report_path: str | Path | None = None) -> EvalResult:
        pairs = self._pairs(split_dir)
        refs = [p[1].read_text(encoding="utf-8").strip() for p in pairs]
        hyps = self.recognize_fn([str(p[0]) for p in pairs])
        result = score([img.name for img, _ in pairs], refs, hyps, self.failure_threshold)
        if report_path is not None:
            lines = [result.summary(), ""]
            for name, ref, hyp, cer in result.failures:
                lines += [f"[{name}] cer={cer:.4f}", f"  REF: {ref}", f"  HYP: {hyp}"]
            Path(report_path).write_text("\n".join(lines), encoding="utf-8")
        return result
