"""The comparison that decides ``correct``.

Serving: once the window has closed and the program's memory is freed, a
sample of the lines it served, drawn from the seed (the request whose lines
took the most decode steps, and ``requests`` - 1 others), is judged line by
line by the reference
(perfbench/reference/) at float32 with TF32 off, in blocks of lines so that
it fits:

  * greedy decoding: ``token_gap``, the widest gap by which a served
    token's log-prob lies below the reference's best at its position;
  * beam search: ``beam_score_gap``, the widest amount by which a served
    row's length-normalised log-prob lies below that of the reference's own
    beam search answer; or, where the cell's check names it,
    ``beam_step_gap``: the widest change of the reference's log-probs that
    would explain a served row (``reference/search.py::beam_step_gaps``).

Each number is held to the cell's ``check`` limit. ``control`` ("tf32"):
the reference at TF32 is put in the program's place (greedy: the token it
puts first at each position of the served rows; beam: its own beam search's
answer), to read what the lower precision gives.
"""

from __future__ import annotations

import numpy as np


def row_steps(row, eos: int, max_len: int) -> int:
    """The decode steps of one served row: its tokens after <sos> up to and
    including its first <eos>, else ``max_len``."""
    gen = np.asarray(row)[1:max_len + 1]
    hit = np.flatnonzero(gen == eos)
    return int(hit[0]) + 1 if hit.size else int(gen.shape[0])


def sample(done: list, seed: int, chk: dict, eos: int, max_len: int) -> list:
    """The served lines to judge -> [(line, row)]: the request whose lines
    took the most steps, and ``chk["requests"]`` - 1 others drawn from the
    seed (all of them where the window finished fewer)."""
    if not done:
        return []
    steps = [sum(row_steps(r, eos, max_len) for r in rows) for _, rows, _, _ in done]
    longest = int(np.argmax(steps))
    rng = np.random.default_rng([seed, 1])
    others = [i for i in range(len(done)) if i != longest]
    n = min(chk["requests"] - 1, len(others))
    pick = [longest] + [int(i) for i in rng.choice(others, size=n, replace=False)]
    return [pair for i in sorted(pick) for pair in zip(done[i][0].lines, done[i][1])]


def reference_weights(spec, config: dict, host_weights, device):
    import torch

    from ..reference.weights import read_index, tree_map

    w = config["weights"]
    if w["kind"] == "checkpoint":
        params, stats = read_index(spec.dir / "data" / w["index"], spec.root)
    else:
        params, stats = host_weights
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return tree_map(to, params), tree_map(to, stats)


def check_serve(spec, cell: dict, config: dict, done: list, ids: dict, seed: int, device, host_weights,
                control: str | None, log=print) -> dict:
    import torch

    from ..reference.model import Ref, chunk_lines
    from ..reference.search import beam_search, beam_step_gaps, seq_scores, token_gaps

    chk, serve = cell["check"], cell["serve"]
    beam, max_len = serve["beam_width"], serve["max_len"]
    eos = ids["eos"]
    picked = sample(done, seed, chk, eos, max_len)
    lines = [ln for ln, _ in picked]
    width = max_len + 2
    rows = np.full((len(lines), width), ids["pad"], np.int64)
    for i, (_, r) in enumerate(picked):
        r = np.asarray(r)[:width]
        rows[i, :r.shape[0]] = r
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params, stats = reference_weights(spec, config, host_weights, device)
        m = {**config["model"], "sos_idx": ids["sos"]}
        ref = Ref(params, stats, m, "f32")
        ctl = Ref(params, stats, m, "tf32") if control == "tf32" else None
        name = chk.get("number", "beam_score_gap" if beam > 1 else "token_gap")
        worst = 0.0
        block = chk["block_lines"]
        with torch.no_grad():
            for s in range(0, len(lines), block):
                chunks, counts = chunk_lines(lines[s:s + block], device)
                served = torch.from_numpy(rows[s:s + block]).to(device)
                mem, pad = ref.encode(chunks, counts)
                if beam > 1:
                    trace = [] if name == "beam_step_gap" else None
                    best = beam_search(ref, mem, pad, beam, max_len, ids["sos"], eos, ids["pad"], trace)
                    if ctl is not None:
                        cmem, cpad = ctl.encode(chunks, counts)
                        served = beam_search(ctl, cmem, cpad, beam, max_len, ids["sos"], eos, ids["pad"])
                    if trace is not None:
                        gap = torch.tensor(beam_step_gaps(trace, best, served, beam, ids["sos"], eos))
                    else:
                        gap = seq_scores(ref, mem, pad, best, eos, max_len) - seq_scores(ref, mem, pad, served, eos,
                                                                                         max_len)
                else:
                    gap = token_gaps(ref, mem, pad, served, eos, max_len, control=ctl)
                worst = max(worst, float(gap.max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    steps = int(sum(row_steps(r, eos, max_len) for r in rows))
    log(f"check: {len(lines)} lines, {steps} served tokens"
        f"{' (control ' + control + ')' if control else ''}")
    return {name: (worst, chk["limit"]), "lines": (len(lines), None), "tokens": (steps, None)}


def _gap(got: dict, want: dict, keep=None) -> float:
    """The widest |got - want| over the leaves, each against the larger of
    its reference value and the median leaf's."""
    keys = [k for k in want if keep is None or keep[k]]
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def check_train(spec, cell: dict, config: dict, samples: list, host, program: dict, seed: int, gseed: int,
                device, control: str | None, log=print) -> dict:
    """The first steps against the reference's: each step's loss (relative),
    the first gradient's norm and the params' change after the steps, leaf
    by leaf (``_gap``); then the window's checked group from the state it
    started from: each step's loss and the params' change over the group.
    Each change is taken over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (a key's bias under softmax
    moves by round-off alone)."""
    import json

    import torch

    from ..reference.batches import first_batches
    from ..reference.train import leaves, rebuild, train_steps
    from ..reference.weights import tree_map

    tr, m = cell["train"], config["model"]
    vocab = json.loads((spec.dir / "data" / "char2idx.json").read_text())
    n = tr["checked_steps"]
    batches = first_batches([(s[0], s[1]) for s in samples], vocab, tr["batch_size"],
                            np.random.default_rng([seed, 5]), n, tr["max_label_len"])
    same_feed = all(np.array_equal(a[k], b[k]) for a, b in zip(batches, program["batches"]) for k in a)
    feed = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    group = program["group"]

    def steps(mode, params, stats, batches, gen_seed, adam=None):
        gen = torch.Generator(device=device)
        gen.manual_seed(gen_seed)
        losses, first, after = train_steps(params, stats, m, batches, [tr["lr"]] * len(batches), gen,
                                           tr["augment_prob"], mode, adam)
        start = leaves(params)
        return (losses, {k: float(v.norm()) for k, v in first.items()},
                {k: float((after[k] - start[k]).norm()) for k in after})

    def kept(grad):
        med = float(np.median(list(grad.values())))
        return {k: v >= 1e-3 * med for k, v in grad.items()}

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        init = tree_map(to, host[0]), tree_map(to, host[1])
        ref_losses, ref_grad, ref_upd = steps("f32", *init, feed, gseed)
        if control == "tf32":
            got_losses, got_grad, got_upd = steps("tf32", *init, feed, gseed)
        else:
            got_losses, got_grad, got_upd = program["losses"], program["grad_norms"], program["update_norms"]
        if group is not None:
            # the program's trees in the reference's layout: the same paths, conv kernels OIHW -> HWIO
            def ref_layout(tree):
                return {k: v.permute(2, 3, 1, 0) if k[0] == "backbone" and v.dim() == 4 else v
                        for k, v in leaves(tree).items()}

            start = ref_layout(group["params"])
            state = rebuild(host[0], start), rebuild(host[1], leaves(group["stats"]))
            adam = {"mu": ref_layout(group["mu"]), "nu": ref_layout(group["nu"]), "count": group["count"]}
            gfeed = [{k: torch.from_numpy(a[k]).to(device) for k in feed[0]} for a in group["arrays"]]
            g_ref_losses, g_ref_grad, g_ref_upd = steps("f32", *state, gfeed, group["seed"], adam)
            if control == "tf32":
                g_losses, _, g_upd = steps("tf32", *state, gfeed, group["seed"], adam)
            else:
                after = ref_layout(group["after"])
                g_losses, g_upd = group["losses"], {k: float((after[k] - start[k]).norm()) for k in after}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    keep = kept(ref_grad)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got_losses, ref_losses))
    lim = cell["check"]
    log(f"check: {n} steps, losses {got_losses} against {ref_losses}; feed equal to the reference's: {same_feed}; "
        f"{sum(not v for v in keep.values())} leaves left out of the change"
        f"{' (control ' + control + ')' if control else ''}")
    out = {"loss_gap": (loss_gap, lim["loss_gap"]),
           "grad_norm_gap": (_gap(got_grad, ref_grad), lim["grad_norm_gap"]),
           "update_norm_gap": (_gap(got_upd, ref_upd, keep), lim["update_norm_gap"])}
    if group is None:  # the window dispatched no group: its path went unchecked
        log("check: the window replayed no group")
        return {**out, "group_loss_gap": (float("inf"), lim["group_loss_gap"]),
                "group_update_gap": (float("inf"), lim["group_update_gap"]), "feed_equal": (float(same_feed), None)}
    log(f"check: a group of {len(gfeed)} steps after {group['count']}, replayed: {group['replayed']}; losses "
        f"{g_losses} against {g_ref_losses}")
    return {**out, "group_loss_gap": (max(abs(a - b) / abs(b) for a, b in zip(g_losses, g_ref_losses)),
                                      lim["group_loss_gap"]),
            "group_update_gap": (_gap(g_upd, g_ref_upd, kept(g_ref_grad)), lim["group_update_gap"]),
            "feed_equal": (float(same_feed), None), "group_replayed": (float(group["replayed"]), None)}
