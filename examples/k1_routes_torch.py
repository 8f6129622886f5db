#!/usr/bin/env python3
"""Where K1's (or K1b's) cluster route stops beating its tile route, on one CUDA card.

    python3 examples/k1_routes_torch.py [--t 256] [--adjoint]

Times kernel K1 (``csrc/lstm_recurrence.cu``) on random inputs at H=192 for
one and two stacked directions and a range of batch sizes: the tile route
(one CTA per ``geometry.tile_rows`` rows) and the cluster route at 2, 4 and
8 batch rows per cluster. With ``--adjoint`` it times kernel K1b
(``csrc/lstm_backward.cu``, the LSTM's adjoint) the same way, its tile route
at ``geometry.k1b_rows`` rows a CTA, on the pre-activation gates, cell states
and a random dh of K1's forward. Prints one line per shape, the route
``geometry.k1_route`` (``k1b_route``) picks, and a last line of JSON. The
crossovers and the cluster residency in
``khmer_ocr_torch/ops/kernels/geometry.py`` come from this script. Exits 2
without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=256, help="time steps")
    ap.add_argument("--adjoint", action="store_true", help="time K1b (the adjoint) in place of K1")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from khmer_ocr_torch.ops.kernels import build, geometry
    from khmer_ocr_torch.ops.kernels.lstm import lstm_recurrence_route
    from khmer_ocr_torch.ops.kernels.lstm_backward import lstm_adjoint_kernel

    build.build(["lstm_recurrence", "lstm_backward"] if args.adjoint else ["lstm_recurrence"])
    hid, g, t = 192, 768, args.t
    kernel = "K1b" if args.adjoint else "K1"
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for ndir in (1, 2):
        for b in (8, 16, 32, 64, 96, 128, 192, 256, 384, 512) + ((768, 1024, 1536, 2048) if args.adjoint else ()):
            xg = torch.randn(ndir, b, t, g, device="cuda", generator=gen) * 0.5
            w = (torch.rand(ndir, hid, g, device="cuda", generator=gen) * 2 - 1) / hid ** 0.5
            if args.adjoint:
                h, c = lstm_recurrence_route(xg, w, with_cell=True)
                hp = torch.cat([torch.zeros_like(h[..., :1, :]), h[..., :-1, :]], dim=-2).reshape(ndir, -1, hid)
                gates = (xg.reshape(ndir, b * t, g) + hp @ w).reshape(xg.shape)
                dh = torch.randn(ndir, b, t, hid, device="cuda", generator=gen)
                tile = (0, geometry.k1b_rows(b, ndir))
                pick = geometry.k1b_route(b, hid, ndir)

                def run(route):
                    lstm_adjoint_kernel(gates, c, dh, w, route)
            else:
                tile = (0, geometry.tile_rows(b))
                pick = geometry.k1_route(b, hid, ndir)

                def run(route):
                    lstm_recurrence_route(xg, w, route)
            times = {}
            for route in [tile] + [(geometry.CLUSTER_CTAS, r) for r in (2, 4, 8)]:
                run(route)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run(route)
                end.record()
                end.synchronize()
                times[f"{route[0]}/{route[1]}"] = start.elapsed_time(end) / 3
            rows.append(dict(kernel=kernel, ndir=ndir, batch=b, t=t, ms=times, picked=f"{pick[0]}/{pick[1]}"))
            print(f"[{kernel} routes] {ndir} direction(s), B={b:4d}, T={t}: "
                  + ", ".join(f"route {k} {v:.3f} ms" for k, v in times.items())
                  + f"; {'k1b_route' if args.adjoint else 'k1_route'} picks {pick} on {smi}", flush=True)
    print(json.dumps(dict(device=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
