"""The one traffic generator: requests of text lines from a mix's parameters.

A mix (``perfbench/traffic/<mix>.json``) fixes:

  * ``lines_per_request``: {"low", "high"}: every block of high - low + 1
    requests holds each count once, in an order drawn from the seed, so
    every seed sends the same sizes;
  * ``line``: where a line comes from. {"source": "real_lines"} draws one of
    the 64 rendered lines (``perfbench/data/real_lines.npz``, 48 px high)
    with replacement. With "join": {"gap_px", "width_px": [low, high]}
    each line is real lines drawn by the seed set side by side with a white
    gap until it reaches its width, and cut there; a request's widths are
    spread evenly over [low, high) (one draw in each of as many equal
    strata as it has lines, in an order drawn from the seed);
  * ``loop``: "closed" with ``clients`` 1: the next request goes once the
    last has come back.

``Request.line_ids`` name each line's parts (indices into the real lines),
so that the reference rebuilds the same pixels from the data alone.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

GAP_WHITE = 255


@dataclasses.dataclass
class Request:
    index: int
    lines: list  # uint8 (48, W) arrays
    parts: list  # per line, the real-line indices it is made of
    widths: list  # per line, its width in px


class RealLines:
    """The frozen rendered lines and their texts."""

    def __init__(self, data_dir: Path):
        z = np.load(data_dir / "real_lines.npz")
        self.lines = [z[f"line_{i}"] for i in range(len(z.files))]


def join_line(real: RealLines, parts: list, gap: int, width: int) -> np.ndarray:
    h = real.lines[0].shape[0]
    pieces = []
    for i, p in enumerate(parts):
        if i:
            pieces.append(np.full((h, gap), GAP_WHITE, np.uint8))
        pieces.append(real.lines[p])
    return np.ascontiguousarray(np.concatenate(pieces, axis=1)[:, :width])


def make_line(real: RealLines, spec: dict, rng: np.random.Generator, width: int | None) -> tuple[np.ndarray, list]:
    n = len(real.lines)
    join = spec.get("join")
    if not join:
        p = int(rng.integers(n))
        return real.lines[p], [p]
    parts, total = [], -join["gap_px"]
    while total < width:
        p = int(rng.integers(n))
        parts.append(p)
        total += join["gap_px"] + real.lines[p].shape[1]
    return join_line(real, parts, join["gap_px"], width), parts


def requests(mix: dict, real: RealLines, seed: int):
    """The mix's requests in order, without end."""
    rng = np.random.default_rng(seed)
    low, high = mix["lines_per_request"]["low"], mix["lines_per_request"]["high"]
    spec = mix["line"]
    join = spec.get("join")
    index = 0
    while True:
        for count in rng.permutation(np.arange(low, high + 1)):
            count = int(count)
            widths = [None] * count
            if join:
                lo, hi = join["width_px"]
                strata = (rng.permutation(count) + rng.random(count)) / count
                widths = [int(lo + s * (hi - lo)) for s in strata]
            lines, parts = [], []
            for w in widths:
                line, p = make_line(real, spec, rng, w)
                lines.append(line)
                parts.append(p)
            yield Request(index, lines, parts, [ln.shape[1] for ln in lines])
            index += 1


def chunks_of(width: int, stride: int = 84) -> int:
    """The 100-px windows of a line ``width`` px wide, every ``stride`` px."""
    return max(1, (width - 1) // stride + 1)


def train_samples(mix: dict, real: RealLines, texts: list, seed: int) -> list:
    """The training set of a mix with ``samples``: each real line equally
    often (up to one), in an order drawn from the seed, so that every seed
    trains on the same sizes -> [(uint8 line, text, [real-line index])]."""
    rng = np.random.default_rng([seed, 4])
    n = len(real.lines)
    order = np.concatenate([rng.permutation(n) for _ in range(-(-mix["samples"] // n))])[:mix["samples"]]
    return [(real.lines[int(p)], texts[int(p)], [int(p)]) for p in order]
