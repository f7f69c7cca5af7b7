"""Where a decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch llama-7b \
        --wbits 4 --group 128 --abits 4 --kvbits 8 --max-batch 4 \
        --prompt-len 128 --max-len 512 --steps 8 [--paged --page-size 64]

Builds the serving model as ``repro_torch.launch.serve`` does (seeded
random weights, RTN-packed), prefills ``--max-batch`` prompts, warms up,
then runs ``--steps`` greedy decode steps twice: timed by the host clock
alone, and under ``torch.profiler``.  Each step ends in one host readback
of the sampled tokens and their rows' finiteness flags, as the Engine's
does.  With ``--paged`` the
prefilled cache is spliced into page pools and every step first backs its
token writes with pages, as the Engine's paged step does.  Prints the
step's wall time, the device's busy time per step (the sum of its kernel
and copy intervals: one stream, so they do not overlap), the idle share,
device events (kernels and copies) per step, and device time per step by
kernel name.
Needs a CUDA device.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch.launch import serve
from repro_torch.serve.kv_cache import PagedCache


def main(argv=None) -> dict:
    ap = serve.build_parser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12,
                    help="kernel names to list")
    args = ap.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_step measures the card: --device cuda")
    cfg, qcfg, params, model, _ = serve.build_model(args)
    if args.prompt_len + 4 + 2 * args.steps > args.max_len:
        raise SystemExit("--max-len too small for the prompt and the steps")
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.max_batch, args.prompt_len)).astype(np.int32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts)},
                                  max_len=args.max_len)
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
    store = None
    if args.paged:
        store = PagedCache(model, args.max_batch, args.max_len,
                           args.page_size, num_pages=args.num_pages)
        for slot in range(args.max_batch):
            if not store.reserve(slot, args.prompt_len):
                raise SystemExit("--num-pages too small for the prompts")
            store.splice(slot, cache, slot, args.prompt_len)
        cache = store.cache
    seq_len = args.prompt_len

    def steps(n: int) -> float:
        nonlocal tok, cache, seq_len
        t0 = time.perf_counter()
        for _ in range(n):
            if store is not None:
                for slot in range(args.max_batch):
                    if not store.ensure_append(slot, seq_len):
                        raise SystemExit("--num-pages too small")
            seq_len += 1
            lg, cache = model.decode_step(params, tok, cache)
            nxt = torch.argmax(lg[:, -1], dim=-1)
            ok = torch.isfinite(lg[:, -1]).all(dim=-1)
            torch.stack((nxt, ok.to(nxt.dtype))).tolist()
            tok = nxt.to(torch.int32)[:, None]
        return (time.perf_counter() - t0) / n

    steps(4)                                   # warm-up
    wall = steps(args.steps)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        wall_prof = steps(args.steps)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name][0] += 1
            by_name[evt.name][1] += evt.time_range.elapsed_us()
    n = args.steps
    busy_ms = sum(us for _, us in by_name.values()) / n / 1e3
    launches = sum(c for c, _ in by_name.values()) / n
    layout = f"paged (pages of {args.page_size})" if args.paged else "linear"
    print(f"[profile] {cfg.name} x{cfg.num_layers} {qcfg.tag()} batch "
          f"{args.max_batch}, prompt {args.prompt_len}, {layout} cache, on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"[profile] decode step wall {wall * 1e3:.3f} ms (host clock, no "
          f"profiler); under the profiler {wall_prof * 1e3:.3f} ms")
    if busy_ms == 0.0:
        print("[profile] device time not measured: the profiler recorded no "
              "device events")
        return {"wall_ms": wall * 1e3, "busy_ms": None}
    # the profiler slows the host, not the kernels: the idle share of a
    # step is read against the unprofiled wall time
    print(f"[profile] device busy {busy_ms:.3f} ms per step, idle share "
          f"{1 - busy_ms / (wall * 1e3):.4f} of the step "
          f"({1 - busy_ms / (wall_prof * 1e3):.4f} of the profiled one); "
          f"{launches:.0f} device events per step")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in rows[:args.top]:
        print(f"[profile]   {us / n / 1e3:9.3f} ms {count / n:7.1f}/step "
              f"{us / n / 1e3 / busy_ms:6.1%}  {name[:90]}")
    return {"wall_ms": wall * 1e3, "wall_profiled_ms": wall_prof * 1e3,
            "busy_ms": busy_ms, "events_per_step": launches}


if __name__ == "__main__":
    main()
