"""Row and column invariance of the float linears: is a row of ``x @ w``
the same bits whatever the number of rows computed with it, and a column
whatever the number of columns?

    PYTHONPATH=src python -m repro_torch.launch.row_probe --device cpu
    python -m repro_torch.launch.row_probe --shapes 4096x4096,4096x11008
    python -m repro_torch.launch.row_probe --columns --device cpu

The float model's linears are ``torch.matmul``, whose library may choose
another algorithm by M (a gemv at one row, a split-K gemm, a vectorised
tail), so the whole-prompt prefill (M = B x T rows), a chunk (B x C) and a
decode step (B) can give one token's row different last bits.  For each
(K, N) the probe multiplies M = 512 seeded rows at once and again in
pieces of 256, 64, 4 and 1 rows, and prints, for each piece size, how many
of the 512 rows differ from the whole product in any bit and the largest
difference over the largest magnitude.  The packed kernels are built to
give equal rows at every M; this probe says whether the float path can
make the same promise (it cannot where a count is above 0).

``--columns`` asks the question a tensor-parallel mesh asks: each rank
multiplies the same rows by its contiguous N / m column slice of ``w``
(m = 2 and 4), and the probe counts the columns of the slices' products
that differ from the whole product in any bit, at 4 rows (decode) and 512
(a prefill).  Where a count is above 0, a column-parallel float linear (the
vocabulary head, the float model's q/k/v and up-projections) is held to
logits on a mesh, not to bits.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device

PIECES = (256, 64, 4, 1)
PARTS = (2, 4)
COLUMN_ROWS = (4, 512)
DEFAULT_SHAPES = "128x384,384x128,4096x4096,4096x11008,11008x4096"
# llama-micro's q / up, down and head; llama-7b's q, up, down and head
COLUMN_SHAPES = ("128x128,128x384,384x128,128x512,"
                 "4096x4096,4096x11008,11008x4096,4096x32000")


def probe(k: int, n: int, device, m: int = 512, seed: int = 0) -> dict:
    """{piece rows: (rows differing from the M-row product, largest
    difference / largest magnitude)} for one seeded (K, N)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    x = torch.randn((m, k), generator=gen, device=device)
    whole = x @ w
    out = {}
    for piece in PIECES:
        parts = torch.cat([x[i:i + piece] @ w for i in range(0, m, piece)])
        diff = (parts != whole).any(-1)
        rel = ((parts - whole).abs().max() / whole.abs().max()).item()
        out[piece] = (int(diff.sum()), rel)
    return out


def probe_columns(k: int, n: int, device, rows: int = 4, seed: int = 0
                  ) -> dict:
    """{m: (columns differing from the whole product, largest difference
    / largest magnitude)} when ``rows`` seeded rows multiply each of the m
    contiguous N / m column slices of ``w`` on its own."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    x = torch.randn((rows, k), generator=gen, device=device)
    whole = x @ w
    out = {}
    for m in PARTS:
        step = n // m
        parts = torch.cat([x @ w[:, i:i + step].contiguous()
                           for i in range(0, n, step)], dim=1)
        moved = (parts != whole).any(0)
        rel = ((parts - whole).abs().max() / whole.abs().max()).item()
        out[m] = (int(moved.sum()), rel)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated KxN")
    ap.add_argument("--columns", action="store_true",
                    help="probe columns at N against N / 2 and N / 4")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the float model runs full float32 products: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    if args.columns:
        for shape in (args.shapes or COLUMN_SHAPES).split(","):
            k, n = (int(v) for v in shape.split("x"))
            for rows in COLUMN_ROWS:
                res = probe_columns(k, n, device, rows)
                results[(k, n, rows)] = res
                print(f"[column-probe] {device.type} K={k} N={n}, {rows} "
                      f"rows: " + "; ".join(
                          f"N/{m}: {c} of {n} columns differ (max {r:.3e})"
                          for m, (c, r) in res.items()))
        return results
    for shape in (args.shapes or DEFAULT_SHAPES).split(","):
        k, n = (int(v) for v in shape.split("x"))
        res = probe(k, n, device)
        results[(k, n)] = res
        print(f"[row-probe] {device.type} K={k} N={n}, 512 rows: " + "; ".join(
            f"pieces of {p}: {c} rows differ (max {r:.3e})"
            for p, (c, r) in res.items()))
    return results


if __name__ == "__main__":
    main()
