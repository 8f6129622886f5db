"""The beam number of the seeded cell (reference/search.py::beam_step_gaps)
on a search whose log-probs are set by hand: two lines, beams of 2, three
steps; the second best first token lies ``TIE`` below the best."""

import pytest
import torch

from perfbench.reference.search import MALFORMED, beam_search, beam_step_gaps

PAD, SOS, EOS, A, B, C = range(6)
TIE = 1e-3


class Table:
    """decode_logp by the prefix alone: the first step prefers A, then B by
    TIE less; every later step A, then B by 1 less; <eos> never near."""

    cfg = {"sos_idx": SOS}

    def decode_logp(self, memory, pad, tokens):
        n, t = tokens.shape
        out = torch.full((n, t, 6), -9.0)
        out[:, :, PAD] = -20.0
        for s in range(t):
            first = s == 0
            out[:, s, A] = -0.5 if first else -1.0
            out[:, s, B] = -0.5 - TIE if first else -2.0
            out[:, s, C] = -5.0
        return out


def search():
    trace = []
    answer = beam_search(Table(), torch.zeros(2, 1, 1), torch.zeros(2, 1, dtype=torch.bool), 2, 3, SOS, EOS, PAD,
                         trace)
    return trace, answer


def gaps(rows):
    trace, answer = search()
    return beam_step_gaps(trace, answer, torch.tensor(rows), 2, SOS, EOS)


def test_the_answer_reads_zero():
    _, answer = search()
    assert answer[0].tolist() == [SOS, A, A, A, PAD]
    assert gaps(answer.tolist()) == [0.0, 0.0]


def test_a_flip_at_the_tie_reads_the_tie():
    assert gaps([[SOS, B, A, A, PAD]] * 2) == pytest.approx([TIE, TIE], abs=1e-6)


def test_a_token_outside_its_beam_reads_its_shortfall():
    assert gaps([[SOS, C, A, A, PAD]] * 2) == pytest.approx([4.5 - TIE] * 2, abs=1e-6)


def test_a_prefix_the_search_dropped_reads_its_shortfall():
    assert gaps([[SOS, A, B, A, PAD]] * 2) == pytest.approx([1.0 - TIE] * 2, abs=1e-6)


def test_a_row_without_sos_is_malformed():
    assert gaps([[PAD] * 5] * 2) == [MALFORMED, MALFORMED]
