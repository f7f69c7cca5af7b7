"""Host time per call of the integer matmul wrappers on the card.

    PYTHONPATH=src python -m repro_torch.launch.wrapper_time

On seeded random codes it runs batches of ``--calls`` back-to-back calls
of the wrappers of ``repro_torch.kernels.int8_matmul``: ``w4a8_matmul`` at
the four llama-7b linear shapes of the served W4A4 g128 path (M = 4:
4096->4096, 4096->11008, 11008->4096; M = 512: 4096->11008), and
``int8_matmul`` and ``w8a8_matmul`` at ``chip_smoke.py`` phase 2's shapes
(those four and M = 512 4096->4096), with one more ``int8_matmul`` row at
M = 512 4096->11008 whose x_q lies 16-byte misaligned, which sends the
call to the body without tensor maps.  It prints, as medians over
``--batches`` batches:

- the host's enqueue per call: the batch's host time before it
  synchronizes, over the calls (nothing in a call synchronizes);
- the time per call of the pipelined batch, synchronize included: the
  larger of the host's enqueue and the card's work sets it.

The script uses only the wrappers' signatures, so it also times another
checkout's wrappers: run this file by path with that checkout's ``src``
first on ``PYTHONPATH``.  The last line is one JSON object.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.core.packing import pack
from repro_torch.kernels import int8_matmul as i8

SHAPES = ((4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096),
          (512, 4096, 11008))
INT8_SHAPES = SHAPES + ((512, 4096, 4096),)


def host_times(call, calls: int, batches: int) -> tuple[float, float]:
    """(host enqueue, pipelined time) per call in ms, medians over
    ``batches`` batches of ``calls`` back-to-back calls."""
    for _ in range(5):
        call()
    host, piped = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / calls * 1e3)
        piped.append((t2 - t0) / calls * 1e3)
    return statistics.median(host), statistics.median(piped)


def report(rows: list, name: str, shape: str, times) -> None:
    row = {"wrapper": name, "shape": shape, "host_ms": times[0],
           "pipelined_ms": times[1]}
    print(f"[wrapper] {name} {shape}: host enqueue {row['host_ms']:.4f} ms "
          f"a call, pipelined {row['pipelined_ms']:.4f} ms a call",
          flush=True)
    rows.append(row)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--batches", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_time measures the card: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    g, bits = 128, 4
    rows = []
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        packed = pack(torch.randint(0, 16, (k, n), generator=gen,
                                    device="cuda", dtype=torch.uint8), bits)
        scale = torch.rand((k // g, n), generator=gen, device="cuda") + 1e-3
        zp = torch.randint(0, 16, (k // g, n), generator=gen, device="cuda"
                           ).to(torch.float32)
        report(rows, "w4a8_matmul", f"M={m} K={k} N={n} w4 g128 a4",
               host_times(lambda: i8.w4a8_matmul(
                   x, packed, scale, zp, bits=bits, group_size=g, a_bits=4),
                   args.calls, args.batches))
    for m, k, n in INT8_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        x_q = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                            dtype=torch.int8)
        x_scale = torch.rand((m, 1), generator=gen, device="cuda") + 1e-3
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8)
        w_scale = torch.rand((n,), generator=gen, device="cuda") + 1e-3
        shape = f"M={m} K={k} N={n}"
        report(rows, "int8_matmul", shape, host_times(
            lambda: i8.int8_matmul(x_q, x_scale, w_q, w_scale), args.calls,
            args.batches))
        report(rows, "w8a8_matmul", shape, host_times(
            lambda: i8.w8a8_matmul(x, w_q, w_scale), args.calls,
            args.batches))
        if (m, k, n) == (512, 4096, 11008):
            x_off = torch.empty(m * k + 4, dtype=torch.int8,
                                device="cuda")[4:].view(m, k)
            x_off.copy_(x_q)
            report(rows, "int8_matmul", shape + " x_q misaligned",
                   host_times(lambda: i8.int8_matmul(x_off, x_scale, w_q,
                                                     w_scale),
                              args.calls, args.batches))
    out = {"device": torch.cuda.get_device_name(0), "wrapper": i8.__file__,
           "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
