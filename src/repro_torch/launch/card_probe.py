"""Two probes on the card behind checks of ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

    PYTHONPATH=src python -m repro_torch.launch.card_probe [--traces N]

- ``profiler``: phase 7 of ``chip_smoke.py`` counts the kernels of one
  call under ``torch.profiler``.  This traces the same four calls
  (``w8a8_matmul`` and ``int8_matmul`` at M = 4 and 512, 4096 -> 11008,
  seeded random int8 codes) ``--traces`` times each and counts the traces
  that hold no device event; for each such trace it reports whether the
  wrapper counted a launch, whether the output equals the plain version
  bit for bit, and which CUDA runtime calls its CPU side holds.
- ``calibration``: the card test's AffineQuant run (llama-micro width, 8
  samples in batches of 4, 2 epochs; w3a16 full sites and w4a4 diagonal
  plus headwise sites) on the card and on the CPU: the largest relative
  gap of the epoch losses and the largest absolute gap of the learned
  leaves, and the same with the learning rates halved (the control the
  test's bounds must reject).

The last line is one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibConfig, _learnable,
                                          calibrate_block)
from repro_torch.core.quantizer import QuantConfig
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import int8_matmul as i8
from repro_torch.models.init import init_block


def profiler_probe(traces: int) -> dict:
    from torch.autograd import DeviceType
    act = torch.profiler.ProfilerActivity
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 128, 4096, device="cuda", generator=gen) * 0.02
    w = torch.randn(4096, 11008, device="cuda", generator=gen) * 0.02
    amax = torch.amax(w.abs(), dim=0)
    w_scale = amax / torch.full_like(amax, 127.0)
    w_q = torch.clamp(torch.round(w / w_scale), -128, 127).to(torch.int8)
    calls = []
    for xa in (x[:, :1], x):
        x2 = xa.reshape(-1, 4096)
        want = i8.w8a8_dynamic_plain(x2, w_q, w_scale)
        x_q, x_scale = i8.act_quant_plain(x2, 8)
        x_q = x_q.to(torch.int8)
        m = x2.shape[0]
        calls.append((f"w8a8_matmul M={m}", "w8a8_matmul", want,
                      lambda xa=xa: ops.w8a8_matmul(xa, w_q, w_scale)))
        calls.append((f"int8_matmul M={m}", "int8_matmul", want,
                      lambda q=x_q, s=x_scale: i8.int8_matmul(q, s, w_q,
                                                              w_scale)))
    for *_, fn in calls:
        fn()
    empty, unequal = [], 0
    for r in range(traces):
        for name, kernel, want, fn in calls:
            before = _lib.LAUNCHES[kernel]
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]
                                        ) as prof:
                got = fn()
                torch.cuda.synchronize()
            equal = torch.equal(got.reshape(want.shape), want)
            unequal += not equal
            events = prof.events()
            if not any(e.device_type == DeviceType.CUDA for e in events):
                empty.append({
                    "trace": r, "call": name, "equal": equal,
                    "wrapper_launches": _lib.LAUNCHES[kernel] - before,
                    "runtime_calls": sorted({
                        e.name for e in events
                        if re.match(r"cu(da)?[A-Z]", e.name)})})
    return {"traces": traces * len(calls), "empty": len(empty),
            "unequal": unequal, "empty_traces": empty}


def calibration_probe() -> dict:
    cfg = get_config("llama-micro")
    out = {}
    for abits, group in ((16, 0), (4, 32)):
        qcfg = QuantConfig(w_bits=3 if abits == 16 else 4, a_bits=abits,
                           group_size=group)
        block = init_block(cfg, torch.Generator().manual_seed(0), "cpu")
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32))
        ccfg = CalibConfig(epochs=2, alpha=0.1, batch_size=4)
        want_qp, want = calibrate_block(block, x, x, cfg, qcfg, ccfg)
        on_dev = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in block.items()}
        half = dataclasses.replace(ccfg, lr_affine=ccfg.lr_affine / 2,
                                   lr_shift=ccfg.lr_shift / 2,
                                   lr_lwc=ccfg.lr_lwc / 2)
        for tag, c in (("same", ccfg), ("half_lr", half)):
            qp, got = calibrate_block(on_dev, x.cuda(), x.cuda(), cfg, qcfg,
                                      c)
            out[f"w{qcfg.w_bits}a{abits} {tag}"] = {
                "losses": got, "cpu_losses": want,
                "loss_rel": max(abs(g / w - 1) for g, w in zip(got, want)),
                "leaf_abs": max((p.cpu() - q).abs().max().item()
                                for (_, p), (_, q) in
                                zip(_learnable(qp), _learnable(want_qp)))}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=150,
                    help="traces of each of the four calls")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("card_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prof = profiler_probe(args.traces)
    print(f"[profiler] {prof['empty']} of {prof['traces']} traces held no "
          f"device event; {prof['unequal']} outputs differed from the plain "
          f"version")
    for e in prof["empty_traces"]:
        print(f"[profiler]   {json.dumps(e)}")
    calib = calibration_probe()
    for k, v in calib.items():
        print(f"[calibration] {k}: epoch losses {v['losses']} (CPU "
              f"{v['cpu_losses']}), largest relative gap {v['loss_rel']:.3e}, "
              f"largest leaf gap {v['leaf_abs']:.3e}")
    out = {"profiler": prof, "calibration": calib}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
