"""Row and column invariance of the float linears: is a row of ``x @ w``
the same bits whatever the number of rows computed with it, and a column
whatever the number of columns?

    PYTHONPATH=src python -m repro_torch.launch.row_probe --device cpu
    python -m repro_torch.launch.row_probe --shapes 4096x4096,4096x11008
    python -m repro_torch.launch.row_probe --columns --device cpu
    python -m repro_torch.launch.row_probe --batches --device cpu \
        --shapes 128x2048x768

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

``--batches`` asks what an expert-parallel MoE mesh asks: each rank runs
``torch.bmm`` over its contiguous E / m experts (m = 2 and 4), the whole
model over all E.  For each (E, d, f) and each capacity C (8: a decode
step's; 24 and 40: a 4 x 64-token chunk's and a 4 x 128-token prompt's at
qwen3-moe's 128 experts top-8), the probe multiplies seeded (E, C, d) slots
by (E, d, f) experts (the up / gate projection) and (E, C, f) by (E, f, d)
(the down projection), the whole batch at once and block by block, and
counts the experts whose products differ in any bit.  It then does the
same through ``models/moe.expert_bmm``, the MoE's product, which calls
``torch.bmm`` on blocks of E / ``EXPERT_SPLITS`` experts, each rank's
experts copied to a tensor of its own as a rank holds them.  Where every
count of the whole-batch calls is 0 the MoE mesh could promise the
unsharded streams with single calls; the blocked counts say whether it
does with the blocks.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.models.moe import expert_block, expert_bmm

PIECES = (256, 64, 4, 1)
PARTS = (2, 4)
COLUMN_ROWS = (4, 512)
DEFAULT_SHAPES = "128x384,384x128,4096x4096,4096x11008,11008x4096"
# llama-micro's q / up, down and head; llama-7b's q, up, down and head
BATCH_CAPS = (8, 24, 40)
# qwen3-moe-30b-a3b's and dbrx-132b's experts: E x d_model x d_ff
BATCH_SHAPES = "128x2048x768,16x6144x10752"
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


def probe_batches(e: int, d: int, f: int, cap: int, device, seed: int = 0
                  ) -> dict:
    """{m: (experts whose up products differ, experts whose down products
    differ, largest difference / largest magnitude, the same two counts
    through ``expert_bmm``)} when each of m contiguous blocks of E / m
    experts runs its own product."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xu = torch.randn((e, cap, d), generator=gen, device=device)
    wu = torch.randn((e, d, f), generator=gen, device=device) / d ** 0.5
    xd = torch.randn((e, cap, f), generator=gen, device=device)
    wd = torch.randn((e, f, d), generator=gen, device=device) / f ** 0.5
    pairs = ((xu, wu), (xd, wd))
    block = expert_block(e)

    def moved(fn, step):
        whole = [fn(x, w) for x, w in pairs]
        parts = [torch.cat([fn(x[i:i + step].clone(), w[i:i + step].clone())
                            for i in range(0, e, step)]) for x, w in pairs]
        rel = max(((p - q).abs().max() / q.abs().max()).item()
                  for p, q in zip(parts, whole))
        return [int((p != q).flatten(1).any(1).sum())
                for p, q in zip(parts, whole)], rel

    out = {}
    for m in PARTS:
        (up, down), rel = moved(torch.bmm, e // m)
        (bup, bdown), _ = moved(lambda x, w: expert_bmm(x, w, block), e // m)
        out[m] = (up, down, rel, bup, bdown)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated KxN")
    ap.add_argument("--columns", action="store_true",
                    help="probe columns at N against N / 2 and N / 4")
    ap.add_argument("--batches", action="store_true",
                    help="probe experts of a bmm over E against E / 2 and "
                         "E / 4 (--shapes ExDxF)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the float model runs full float32 products: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    if args.batches:
        for shape in (args.shapes or BATCH_SHAPES).split(","):
            e, d, f = (int(v) for v in shape.split("x"))
            for cap in BATCH_CAPS:
                res = probe_batches(e, d, f, cap, device)
                results[(e, d, f, cap)] = res
                print(f"[batch-probe] {device.type} E={e} d={d} f={f} "
                      f"C={cap}: " + "; ".join(
                          f"E/{m}: {u} up / {dn} down of {e} experts differ "
                          f"(max {r:.3e}), in blocks of {expert_block(e)} "
                          f"{bu} / {bd}"
                          for m, (u, dn, r, bu, bd) in res.items()))
        return results
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
