"""Faults planted under the timed path, to see the check come out false.

Each is a context manager that patches the program where the served tokens
are produced:

  * ``token``: one token of each bucket batch's first row altered as the
    decode returns it (``khmer_ocr_torch.infer.predictor.decode_batch``,
    which ``infer_batch`` calls for every bucket batch);
  * ``half``: the second half of each bucket batch's lines left out: their
    rows come back all <pad>, as they were before a decode wrote them
    (``Predictor._drain``, where a batch's rows reach the caller's list);
  * ``train_half``: a train step that leaves out the second half of its
    batch and takes the mean loss over the rest
    (``khmer_ocr_torch.train.step.loss_fn``, which each step calls);
  * ``train_group``: a group of K > 1 steps that trains each of its steps
    on the group's first batch (``khmer_ocr_torch.train.step.step_body``,
    whose body each captured graph replays); a single step is left as it
    is.

Run as a script it drives one run of a cell on the card with a fault
planted and prints the result line:

    python3 -m perfbench.tests.faults --fault token --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

FAULTS = ("token", "half", "train_half", "train_group")


@contextlib.contextmanager
def planted(fault: str):
    from khmer_ocr_torch.infer import predictor
    from khmer_ocr_torch.train import step

    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    if fault == "train_half":
        owner, name = step, "loss_fn"
        original = step.loss_fn

        def broken(params, batch_stats, batch, *args, **kwargs):
            half = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
            return original(params, batch_stats, half, *args, **kwargs)
    elif fault == "train_group":
        owner, name = step, "step_body"
        original = step.step_body

        def broken(*args, **kwargs):
            body = original(*args, **kwargs)

            def first_batch_only(state, stacked, generator, scalars):
                if scalars.shape[0] > 1:
                    stacked = {k: v[:1].expand_as(v).contiguous() for k, v in stacked.items()}
                return body(state, stacked, generator, scalars)

            return first_batch_only
    elif fault == "token":
        owner, name = predictor, "decode_batch"
        original = predictor.decode_batch

        def broken(*args, **kwargs):
            tokens = original(*args, **kwargs).clone()
            tokens[0, 1] = (tokens[0, 1] + 7) % 124
            return tokens
    else:
        owner, name = predictor.Predictor, "_drain"
        original = predictor.Predictor._drain

        def broken(entry, results, flight):
            original(entry, results, flight)
            indices = entry[0].indices
            for idx in indices[(len(indices) + 1) // 2:]:
                results[idx] = results[idx] * 0

        broken = staticmethod(broken)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, staticmethod(original) if fault == "half" else original)


def main(argv) -> int:
    import argparse
    import json

    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from perfbench.harness.cli import run_cell
    from perfbench.harness.spec import Spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    with planted(args.fault):
        out = run_cell(Spec(root), args.workload, args.seed, args.seconds, False, "cuda")
    print(json.dumps({"fault": args.fault, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
