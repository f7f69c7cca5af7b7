"""Row invariance of the float linears: is a row of ``x @ w`` the same bits
whatever the number of rows computed with it?

    PYTHONPATH=src python -m repro_torch.launch.row_probe --device cpu
    python -m repro_torch.launch.row_probe --shapes 4096x4096,4096x11008

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
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device

PIECES = (256, 64, 4, 1)
DEFAULT_SHAPES = "128x384,384x128,4096x4096,4096x11008,11008x4096"


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default=DEFAULT_SHAPES,
                    help="comma-separated KxN")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the float model runs full float32 products: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for shape in args.shapes.split(","):
        k, n = (int(v) for v in shape.split("x"))
        res = probe(k, n, device)
        results[(k, n)] = res
        print(f"[row-probe] {device.type} K={k} N={n}, 512 rows: " + "; ".join(
            f"pieces of {p}: {c} rows differ (max {r:.3e})"
            for p, (c, r) in res.items()))
    return results


if __name__ == "__main__":
    main()
