"""Host time per call of the ``w4a8_matmul`` wrapper on the card.

    PYTHONPATH=src python -m repro_torch.launch.wrapper_time

At the four llama-7b linear shapes of the served W4A4 g128 path (M = 4:
4096->4096, 4096->11008, 11008->4096; M = 512: 4096->11008), on seeded
random codes, it runs batches of ``--calls`` back-to-back calls of
``repro_torch.kernels.int8_matmul.w4a8_matmul`` and prints, as medians over
``--batches`` batches:

- the host's enqueue per call: the batch's host time before it
  synchronizes, over the calls (nothing in a call synchronizes);
- the time per call of the pipelined batch, synchronize included: the
  larger of the host's enqueue and the card's work sets it.

The script uses only the wrapper's signature, so it also times another
checkout's wrapper: run this file by path with that checkout's ``src``
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

        def call():
            i8.w4a8_matmul(x, packed, scale, zp, bits=bits, group_size=g,
                           a_bits=4)
        for _ in range(5):
            call()
        host, piped = [], []
        for _ in range(args.batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / args.calls * 1e3)
            piped.append((t2 - t0) / args.calls * 1e3)
        row = {"shape": f"M={m} K={k} N={n} w4 g128 a4",
               "host_ms": statistics.median(host),
               "pipelined_ms": statistics.median(piped)}
        print(f"[wrapper] w4a8_matmul {row['shape']}: host enqueue "
              f"{row['host_ms']:.4f} ms a call, pipelined "
              f"{row['pipelined_ms']:.4f} ms a call", flush=True)
        rows.append(row)
    out = {"device": torch.cuda.get_device_name(0), "wrapper": i8.__file__,
           "w4a8_matmul": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
