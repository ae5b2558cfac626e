#!/usr/bin/env python3
"""Time one checkout's merge pass and float64 function on one NVIDIA GPU.

    python3 compare_kernels.py --root DIR [--label NAME] [--f64] [--seed 0]

Imports spark_rapids_ml_torch from DIR (a checkout, or an unpacked
`git archive` of one; its kernels build there at first use) and prints one
JSON line per measurement:

- the merge pass (`merge_partials`) on sorted partial lists made on the
  card, float32 and float64, at (rows, S, k) = (40, 32, 1000),
  (40, 8, 100), (40, 5, 32) and (10000, 5, 32): the mean ms of a call from
  Python (CUDA events) and of one call inside a CUDA graph (the kernel's
  own time), each result held bit for bit against the checkout's
  `merge_partials_reference`.  The lists tie on scores, and a quarter of
  them end early (+inf, -1), as lists cut by the splits' shared bound do;
- with --f64, the float64 `fused_topk_sqdist` (main kernel + merge, the
  wrapper's split count) at 200,000 x 128 items / 2,000 queries and
  1,000,000 x 128 items / 10,000 queries, k = 32.

A case the checkout's wrapper refuses (float64 merges before the port had
them) prints as unsupported.  To compare two trees, unpack the parent into
a directory .gitignore lists and run parent, change, change, parent in one
call; compare only numbers taken in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_MERGE_SHAPES = ((40, 32, 1000), (40, 8, 100), (40, 5, 32), (10_000, 5, 32))
_F64_SHAPES = ((200_000, 2_000), (1_000_000, 10_000))


def partial_lists(q: int, s: int, k: int, dtype, device, gen):
    """(q, S, k) lists in (score, position) order: scores on a grid of
    1/64 (so they tie), positions unique in a row and increasing with the
    split; a quarter of the lists end early."""
    import torch

    scores = torch.round(torch.randn((q, s, k), generator=gen, device=device) * 64) / 64
    # positions in order, scores random: a stable sort by score leaves the
    # ties in position order
    pos = torch.arange(k, device=device).expand(q, s, k) + \
        torch.arange(s, device=device)[None, :, None] * k
    scores, order = torch.sort(scores, dim=2, stable=True)
    pos = torch.gather(pos, 2, order)
    cut = torch.randint(k // 2, k + 1, (q, s, 1), generator=gen, device=device)
    short = (torch.rand((q, s, 1), generator=gen, device=device) < 0.25) & (
        torch.arange(k, device=device)[None, None, :] >= cut)
    part_d = torch.where(short, float("inf"), scores).to(dtype).contiguous()
    part_i = torch.where(short, -1, pos).to(torch.int32).contiguous()
    q2 = (torch.rand(q, generator=gen, device=device) * 100).to(dtype)
    return part_d, part_i, q2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, cuda_ms, graph_ms

    sys.path.insert(0, os.path.abspath(args.root))
    from spark_rapids_ml_torch.ops import fused_knn as fk

    device = torch.device("cuda:0")
    card = card_line()
    label = args.label or args.root

    def emit(**rec):
        print(json.dumps({"label": label, "card": card, **rec}), flush=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    for dtype in (torch.float32, torch.float64):
        for q, s, k in _MERGE_SHAPES:
            part_d, part_i, q2 = partial_lists(q, s, k, dtype, device, gen)
            name = f"merge_partials {str(dtype)[6:]} {q} rows x {s} lists x k={k}"
            try:
                md, mi = fk.merge_partials(part_d, part_i, q2, k)
            except (TypeError, ValueError) as e:
                emit(case=name, unsupported=str(e))
                continue
            rd, ri = fk.merge_partials_reference(part_d, part_i, q2, k)
            exact = torch.equal(md, rd) and torch.equal(mi, ri)
            call_ms = cuda_ms(lambda: fk.merge_partials(part_d, part_i, q2, k), reps=20)
            device_ms = graph_ms(lambda: fk.merge_partials(part_d, part_i, q2, k))
            emit(case=name, call_ms=call_ms, device_ms=device_ms, bit_exact=exact)
            if not exact:
                return 1
    if args.f64:
        d, k = 128, 32
        for n, q in _F64_SHAPES:
            g = torch.Generator(device=device).manual_seed(args.seed + 5)
            items = torch.randn((n, d), dtype=torch.float64, device=device, generator=g)
            queries = torch.randn((q, d), dtype=torch.float64, device=device, generator=g)
            valid = torch.ones(n, dtype=torch.float64, device=device)
            ms = cuda_ms(lambda: fk.fused_topk_sqdist(items, valid, queries, k), reps=3)
            emit(case=f"fused_topk_sqdist float64 {n} x {d} items, {q} queries, k={k}", ms=ms)
            del items, queries, valid
    return 0


if __name__ == "__main__":
    sys.exit(main())
