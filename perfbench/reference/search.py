"""Plain beam search and the numbers that judge served tokens.

Token rows are laid out as the program returns them: <sos>, the generated
tokens, <eos> where the line ended, <pad> after it. A row's *steps* are its
tokens after <sos> up to and including its first <eos>, or all ``max_len``
of them when it has none. The reference is fed <sos> first whatever the row
holds there, and a row that does not start with <sos> reads ``MALFORMED``.

  * ``token_gaps``: for each row, the widest gap by which a generated
    token's log-prob lies below the reference's best at its position
    (teacher-forced on the row): 0 where every token is the reference's
    argmax. The number for greedy decoding.
  * ``beam_search`` and ``seq_scores``: the search of the reference's beam
    decode (each beam expands its own top K; an <eos> candidate retires
    with its raw score over its length, <sos> and <eos> counted, and
    replaces the best completion only when better; the next K beams are
    the best K candidates without <eos>; the answer is the best completion,
    else the top beam), every step run (its early exit changes no answer);
    ``seq_scores`` scores rows by that length-normalised log-prob. The
    number for beam search on the trained model is the reference's answer's
    score less the served row's, both scored by ``seq_scores``: 0 where the
    rows agree.
  * ``beam_step_gaps``: the number for beam search where near-ties are
    common: 0 for a served row equal to the reference's answer, else how
    small a change of the reference's log-probs would explain it, read from
    the reference's own search (``beam_search(..., trace=[])``). The row is
    walked through the search to where it first leaves it: there its token
    lies below its beam's K-th best token, or its prefix below the K-th
    candidate the search kept, by the gap. A row that never leaves the
    search lost to the answer elsewhere in it: it reads the smaller of its
    shortfall (a completion below the search's best, a row run to
    ``max_len`` below the top beam) and the search's narrowest decision on
    that line (a beam's K-th token over its next, the K-th kept candidate
    over the first dropped, a completion against the best before it). Each
    is a difference of log-probs, so a search that flips at a near-tie
    reads the size of the tie, not how far the two answers then drift
    apart.
"""

from __future__ import annotations

import torch

from .model import NEG, Ref

MALFORMED = 1e30  # the gap of a row that does not start with <sos>


def row_steps(rows: torch.Tensor, eos: int, max_len: int) -> torch.Tensor:
    """(B, L) rows -> (B,) the number of steps each row took."""
    gen = rows[:, 1:max_len + 1]
    is_eos = gen == eos
    first = torch.where(is_eos.any(1), is_eos.float().argmax(1) + 1, torch.full_like(is_eos[:, 0], gen.shape[1],
                                                                                      dtype=torch.long))
    return first


def served_logp(ref: Ref, memory, pad, rows: torch.Tensor, eos: int, max_len: int):
    """Teacher-forced log-probs over each row's steps -> (logp (B, S, V) of
    the token after each of the first S = max steps positions, the row's
    tokens at those positions (B, S), valid (B, S))."""
    steps = row_steps(rows, eos, max_len)
    s = int(steps.max())
    inp = rows[:, :s].clone()
    inp[:, 0] = ref.cfg["sos_idx"]
    logp = ref.decode_logp(memory, pad, inp)
    nxt = rows[:, 1:s + 1]
    valid = torch.arange(s, device=rows.device)[None, :] < steps[:, None]
    return logp, nxt, valid


def token_gaps(ref: Ref, memory, pad, rows, eos: int, max_len: int, control: Ref | None = None) -> torch.Tensor:
    """(B,) each row's widest gap below the reference's best. With
    ``control``: the gap, under ``ref``, of the token that ``control`` puts
    first at each position of the same rows, in place of the row's own."""
    logp, nxt, valid = served_logp(ref, memory, pad, rows, eos, max_len)
    if control is not None:
        nxt = served_logp(control, memory, pad, rows, eos, max_len)[0].argmax(-1)
    gap = logp.max(-1).values - logp.gather(-1, nxt[..., None])[..., 0]
    gap = torch.where(valid, gap, torch.zeros_like(gap)).max(1).values
    return torch.where(rows[:, 0] == ref.cfg["sos_idx"], gap, torch.full_like(gap, MALFORMED))


def seq_scores(ref: Ref, memory, pad, rows, eos: int, max_len: int) -> torch.Tensor:
    """(B,) each row's log-prob over its steps, divided by its length with
    <sos> and <eos> (steps + 1)."""
    logp, nxt, valid = served_logp(ref, memory, pad, rows, eos, max_len)
    lp = torch.where(valid, logp.gather(-1, nxt[..., None])[..., 0], torch.zeros_like(valid, dtype=logp.dtype))
    score = lp.sum(1) / (valid.sum(1) + 1).to(lp.dtype)
    return torch.where(rows[:, 0] == ref.cfg["sos_idx"], score, torch.full_like(score, -MALFORMED))


def beam_search(ref: Ref, memory, pad, k: int, max_len: int, sos: int, eos: int, pad_idx: int,
                trace: list | None = None) -> torch.Tensor:
    """The reference's beam search over a batch of memories -> answer rows
    (B, max_len + 2). ``trace``: a list that gets, for each step, the
    log-probs of every lane (B, K, V), the lanes' scores before the step
    (B, K), the rows kept after it (B, K, step + 2), their scores (B, K)
    and the narrowest of its decisions (B,) (``beam_step_gaps``); and last
    the best completion's score (B,)."""
    b, dev = memory.shape[0], memory.device
    mem = memory.repeat_interleave(k, 0)
    mpad = pad.repeat_interleave(k, 0)
    seqs = torch.full((b, k, max_len + 2), pad_idx, dtype=torch.long, device=dev)
    seqs[:, :, 0] = sos
    scores = torch.full((b, k), NEG, device=dev)
    scores[:, 0] = 0.0
    best = torch.full((b,), NEG, device=dev)
    best_rows = torch.full((b, max_len + 2), pad_idx, dtype=torch.long, device=dev)
    ar = torch.arange(b, device=dev)
    for pos in range(max_len):
        logp = ref.decode_logp(mem, mpad, seqs[:, :, :pos + 1].reshape(b * k, pos + 1))[:, -1].view(b, k, -1)
        top_lp, top_id = logp.topk(k, dim=-1)
        cand = scores[:, :, None] + top_lp
        is_eos = top_id == eos
        done = torch.where(is_eos, cand / (pos + 2), torch.full_like(cand, NEG)).amax(2)
        lane = done.argmax(1)
        better = done[ar, lane] > best
        if trace is not None:  # a completion against the best before it, where both exist
            vs_best = torch.where((done[ar, lane] > NEG / 2) & (best > NEG / 2), (done[ar, lane] - best).abs(),
                                  torch.full_like(best, float("inf")))
        row = seqs[ar, lane].clone()
        row[:, pos + 1] = eos
        best_rows = torch.where(better[:, None], row, best_rows)
        best = torch.where(better, done[ar, lane], best)
        before = scores
        flat = torch.where(is_eos, torch.full_like(cand, NEG), cand).view(b, k * k)
        scores, idx = flat.topk(k, dim=1)

        parent = idx // k
        seqs = torch.gather(seqs, 1, parent[:, :, None].expand(-1, -1, seqs.shape[2])).clone()
        seqs[:, :, pos + 1] = top_id.view(b, k * k).gather(1, idx)
        if trace is not None:
            # a live beam's K-th token over its next, and the K-th kept candidate over the first dropped
            tok = logp.topk(k + 1, dim=-1).values
            tok = torch.where(before > NEG / 2, tok[..., k - 1] - tok[..., k], torch.full_like(before, float("inf")))
            kept = scores[:, k - 1] - flat.topk(k + 1, dim=1).values[:, k]
            narrowest = torch.minimum(torch.minimum(tok.amin(1), kept), vs_best)
            trace.append((logp.cpu(), before.cpu(), seqs[:, :, :pos + 2].cpu(), scores.cpu(), narrowest.cpu()))
    if trace is not None:
        trace.append(best.cpu())
    return torch.where((best > NEG / 2)[:, None], best_rows, seqs[:, 0])


def beam_step_gaps(trace: list, answer: torch.Tensor, rows: torch.Tensor, k: int, sos: int, eos: int) -> list:
    """Each served row judged by the reference's search over the same lines
    (``trace`` and ``answer`` of ``beam_search``) -> [its gap] (module
    docstring)."""
    steps, best = trace[:-1], trace[-1]
    narrowest = torch.stack([st[4] for st in steps]).amin(0)
    out = []
    for i, (row, ans) in enumerate(zip(rows.cpu().tolist(), answer.cpu().tolist())):
        if row[0] != sos:
            out.append(MALFORMED)
            continue
        if row == ans:
            out.append(0.0)
            continue
        lane, gap, short = 0, None, None
        for p, (logp, before, kept, kept_scores, _) in enumerate(steps):
            tok, lp = row[p + 1], logp[i, lane]
            kth = lp.topk(k).values[-1]
            if lp[tok] < kth:  # not among its beam's K best tokens
                gap = float(kth - lp[tok])
                break
            cum = before[i, lane] + lp[tok]  # float32, as the search adds it
            if tok == eos:  # a completion below the search's best
                short = float(best[i]) - float(cum / (p + 2))
                break
            lane = next((j for j in range(k) if kept[i, j].tolist() == row[:p + 2]), None)
            if lane is None:  # a prefix the search did not keep
                gap = max(float(kept_scores[i, -1] - cum), 0.0)
                break
        if gap is None:
            if short is None:  # run to max_len inside the search: below its top beam, or its completion
                short = float(steps[-1][3][i, 0] - cum) if float(best[i]) < NEG / 2 else float("inf")
            gap = min(max(short, 0.0), float(narrowest[i]))
        out.append(gap)
    return out
