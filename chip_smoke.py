"""Quickest proof that the PyTorch/CUDA port builds and serves on the card.

    python3 chip_smoke.py

Runs from the root of a checkout, on one CUDA device, in phases; any
failure raises (exit code != 0).

1. build: the CUDA kernels of ``src/repro_torch/csrc`` are built from
   source (one nvcc per file, in parallel) and loaded; the SASS of the
   int8 tile body must hold TMA loads, mbarrier waits and wgmma.
2. kernels: each kernel against its plain PyTorch version at the llama-7b
   shapes the serving path gives it (plus kv16/kv8/kv4, GQA, ragged-length
   and page-16 cases, and decode over a 2048-position context in both
   layouts), with the error beside its stated tolerance, the
   kernel's time, the plain version's time, one PyTorch library call's time
   as a yardstick (the port never calls it) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type).  Times are CUDA-event medians with the 50 MB L2 flushed
   before every launch, since the serving path finds each weight cold.
   A call whose host enqueue outlasts the flush is timed with the card
   waiting for it; for w4a8_matmul, int8_matmul and w8a8_matmul the log
   line also gives the time with the enqueue hidden behind a device sleep
   (the call's device work alone) and the host's enqueue per call; for
   the int8 pair also the device work alone after a flush that leaves the
   L2 clean.  Each paged kernel must equal its linear kernel bit for bit on the same
   contents, a one-token chunk must equal decode, and a chunk split in two
   must equal the whole chunk, in every format and both layouts;
   w4a8_matmul must equal its plain version bit for bit at the four
   llama-7b linear shapes, and its rows and dequant_matmul's must be the
   same at M = 4 as in the M = 512 product.  Where PERF.md records the
   time of a case before its kernel was redesigned, the log line shows it
   beside the new one.
   int8_matmul and w8a8_matmul at the four llama-7b linear shapes and the
   512-token 4096 -> 4096 product, and quantize_pack at the llama-7b weight
   shapes (w4 g128 both ways, w2, w8 and per-channel w4), must equal their
   plain versions bit for bit; the int8 pair's rows at M = 4 must equal
   the same rows at M = 512, and each log line names the body of
   csrc/int8_matmul.cu that ran (decode, wgmma or mma_sync).
3. serve: llama-7b at full width, W4A4 g128 with the kv8 cache, greedy,
   through ``repro_torch.launch.serve`` (4 requests, prompt 128, 32 new
   tokens, batch 4, max_len 512), with the launch counters zeroed just
   before and read just after; then a teacher-forced check of the same
   tokens against the plain versions on the card.
4. serve at a16: W4A16 g128 with the fp cache (depth cut), which runs
   dequant_matmul.
5. serve phase 3's model and requests over page pools of 64: (a) with
   whole-prompt admission into an automatic pool, whose streams must equal
   phase 3's token for token; (b) with chunks of 64 into a 10-page pool
   (the working set needs 12), which must preempt, complete every request
   and pass the per-block teacher-forced check over pages.
6. serve the same model at kv4 (4 requests x (128 + 8), paged, chunks of
   64), gated by the same per-block check.
7. repack: the reference's entry points of the three kernels no serving
   path runs (``ops.quantize_pack``, ``ops.w8a8_matmul``,
   ``int8_matmul.int8_matmul``; no serving path of the reference runs
   them either), at full width over every layer of the served tree.  Each
   layer's float block is drawn again on the card from the generator
   sequence that built phase 3's tree, and ``ops.quantize_pack`` (w4 g128)
   of each of its seven linears must equal the QTensor phase 3 served,
   packed bytes, scales and zero points (224 launches); ``wq`` and ``w_up``
   as symmetric per-channel int8 codes go through ``ops.w8a8_matmul`` and
   ``int8_matmul`` at M = 4 and 512 on phase 3's prompt embeddings, bit for
   bit against the plain version; then one call of each at each M under
   torch.profiler must run one kernel (int8_matmul) or two (w8a8_matmul:
   the pre-pass and the product) and return the plain version's bits; a
   trace whose device records the profiler lost (its CPU side holds the
   launch) is taken again and counted in the summary's
   ``profiler_retries``.
8. calibrate: AffineQuant calibration of llama-7b-width blocks on the
   card (depth cut to 2 layers; 32 x 512 Markov tokens, batch 8, 3 epochs,
   alpha 0.1) through ``repro_torch.launch.calibrate``, then serving of the
   packed tree: (a) W4A4 g128 kv8 with diagonal norm sites (merged into the
   norms, which gain a bias) and 32 headwise vo transforms, through
   w4a8_matmul; (b) W4A16 g128 kv16 with full 4096 x 4096 norm sites under
   the gradual mask, kept as explicit activation factors, through
   dequant_matmul.  Gates: every epoch loss finite and each block's last
   below its first; every full and headwise effective matrix strictly
   diagonally dominant (margin > 0); the packed tree written by
   ``checkpoints.save`` and read back by ``load_tree`` byte for byte;
   ``serve --load-packed`` on that directory gives the in-memory tree's
   greedy streams (4 requests x (128 + 32)); the kernel path against the
   plain versions (a: the per-block check, b: phase 4's end-to-end check);
   and for (b) the packed tree's teacher-forced logits against the
   fake-quant tree through the float forward within FAKE_TOL.  Logs the
   median step time, peak memory, perplexities and the phase's wall time.
9. summary.  Every kernel's ``launches`` is the count of the runs above
   that drive the main path (phases 3-6 and the serving runs of phase 8 for
   the six serving kernels, phase 7 for the other three), never of the
   comparisons of phases 2 and 8.

Phases 3, 5, 6 and 7 share one packed llama-7b tree.
The last lines are one JSON object of the kernels (with phase 7's
``profiler_retries``), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
INT8_OPS_PER_S = 1979e12      # dense int8 tensor cores
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores

LAYERS = 32                   # llama-7b depth; cut here only if time forces
A16_LAYERS = 8
KERNELS = {"w4a8_matmul": "w4a8_matmul.cu",        # name -> source file
           "dequant_matmul": "dequant_matmul.cu",
           "flash_decode": "flash_decode.cu", "flash_prefill": "flash_prefill.cu",
           "flash_decode_paged": "flash_decode.cu",
           "flash_prefill_paged": "flash_prefill.cu",
           "int8_matmul": "int8_matmul.cu", "w8a8_matmul": "int8_matmul.cu",
           "quantize_pack": "quantize_pack.cu"}
# (M, K, N) of llama-7b's linears: decode (M 4) and a 512-token prefill
LINEAR_SHAPES = ((4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096),
                 (512, 4096, 11008))
# Earlier times of the redesigned kernels as PERF.md records them (H100
# 80GB HBM3, 700 W), logged beside this run's.
_MAIN_PREFILL = "B=4 C=128 S=128 Hkv=32 G=1 D=128 kv{} offset=[0, 0, 0, 0] chunk_len=[128, 128, 128, 128]"
_MAIN_PAGED = ("B=4 C=128 pages of 64, 8/seq, Hkv=32 G=1 D=128 kv{} "
               "offset=[0, 0, 0, 0] chunk_len=[128, 128, 128, 128]")
_MAIN_DECODE = "B=4 S=512 Hkv=32 G=1 D=128 kv{} cur_len=[144, 144, 144, 144]"
_MAIN_DECODE_PAGED = ("B=4 pages of 64, 8/seq, Hkv=32 G=1 D=128 kv{} "
                      "cur_len=[144, 144, 144, 144]")
EARLIER_MS = {
    "flash_decode " + _MAIN_DECODE.format(8): 0.0850,
    "flash_decode " + _MAIN_DECODE.format(4): 0.0864,
    "flash_decode_paged " + _MAIN_DECODE_PAGED.format(8): 0.0871,
    "flash_decode_paged " + _MAIN_DECODE_PAGED.format(4): 0.0904,
    "dequant_matmul M=4 K=4096 N=11008 w4 g128": 0.3616,
    "w4a8_matmul M=4 K=4096 N=4096 w4 g128 a4": 0.0803,
    "w4a8_matmul M=4 K=4096 N=11008 w4 g128 a4": 0.0829,
    "w4a8_matmul M=4 K=11008 N=4096 w4 g128 a4": 0.2104,
    "w4a8_matmul M=512 K=4096 N=11008 w4 g128 a4": 1.1112,
    "flash_prefill " + _MAIN_PREFILL.format(8): 0.1794,
    "flash_prefill " + _MAIN_PREFILL.format(4): 0.2205,
    "flash_prefill_paged " + _MAIN_PAGED.format(8): 0.1859,
    "flash_prefill_paged " + _MAIN_PAGED.format(4): 0.2639,
    # the earlier int8 bodies (mma.sync tile, split-K dp4a decode)
    "int8_matmul M=4 K=4096 N=4096": 0.0243,
    "int8_matmul M=4 K=4096 N=11008": 0.0445,
    "int8_matmul M=4 K=11008 N=4096": 0.0610,
    "int8_matmul M=512 K=4096 N=11008": 0.2078,
    "w8a8_matmul M=4 K=4096 N=4096": 0.0389,
    "w8a8_matmul M=4 K=4096 N=11008": 0.0520,
    "w8a8_matmul M=4 K=11008 N=4096": 0.0582,
    "w8a8_matmul M=512 K=4096 N=11008": 0.2173,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each.  With
    hide_host, a device sleep between the flush and the call keeps the card
    busy while the host enqueues the call, so the events time the call's
    device work alone.  With clean_l2, the flush buffer is also read back
    before the call, so the L2 holds no dirty lines for the call to write
    back.  ``host_ms``: the median host time of the last timing's calls
    (their enqueue: nothing in them synchronizes)."""

    HIDE_CYCLES = 300_000          # ~0.17 ms at the H100's 1.755 GHz

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.host_ms = None

    def __call__(self, fn, reps: int = 15, warm: int = 2,
                 hide_host: bool = False, clean_l2: bool = False) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs, host = [], []
        for _ in range(reps):
            self.flush.zero_()
            if clean_l2:
                self.flush.max()
            if hide_host:
                torch.cuda._sleep(self.HIDE_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        self.host_ms = statistics.median(host) * 1e3
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> None:
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's kernels "
                         "run only on the card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(src/repro_torch not found)")
    sys.path.insert(0, str(SRC))
    # float32 matmuls left to PyTorch (vocab head, activation transforms,
    # the plain versions) stay full float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    results = {}

    # ---- 1. build ----------------------------------------------------------
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.lib()
    log(f"[build] {len(_lib.SOURCES)} sources -> {_lib.BUILD_INFO['path']} "
        f"in {time.perf_counter() - t0:.1f} s (cached={_lib.BUILD_INFO['cached']})")
    log_path = _lib.BUILD_INFO.get("log")
    if log_path and Path(log_path).exists():
        for line in Path(log_path).read_text().splitlines():
            if "registers" in line or "spill stores" in line:
                log("[build]   " + line.strip())

    check_wgmma_sass(_lib)

    timer = Timer(torch)
    check_kernels(torch, timer, results)
    check_paged_kernels(torch, timer, results)
    check_int8_kernels(torch, timer, results)
    check_quantize_pack(torch, timer, results)
    del timer
    torch.cuda.empty_cache()

    # ---- 3-6. serving; one packed llama-7b tree shared by 3, 5 and 6 ------
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    params = serve.build_model(serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(LAYERS)]))[2]
    log(f"[serve] random init + RTN packing of the llama-7b tree "
        f"{time.perf_counter() - t0:.1f} s")
    counts, streams, prompts = serve_w4a4(torch, params)
    phases = [serve_a16(torch), serve_paged(torch, params, streams),
              serve_kv4(torch, params)]
    repacked, retries = repack(torch, params, prompts)
    phases.append(repacked)
    del params
    torch.cuda.empty_cache()

    # ---- 8. calibrate llama-7b-width blocks and serve what they pack -------
    phases.append(calibrate_phase(torch))

    # ---- 9. summary --------------------------------------------------------
    for phase in phases:
        for name, n in phase.items():
            counts[name] += n
    kernels = []
    for name in KERNELS:
        r = results[name]
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was never launched on the main path")
        kernels.append({"name": name, "route": "cuda",
                         "source": f"src/repro_torch/csrc/{KERNELS[name]}",
                         "replaces": r["replaces"], "launches": counts[name],
                         "max_abs_err": r["max_abs_err"], "tol": r["tol"],
                         "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"], "shape": r["shape"],
                         # aliases of the numbers above
                         "tpu": r["replaces"], "max_err": r["max_abs_err"],
                         "kernel_ms": r["ms"],
                         "bound_us": r["bound_ms"] * 1e3})
    log(f"[total] {time.perf_counter() - t_start:.1f} s; phase 7 traced "
        f"{retries} call(s) again after the profiler lost their device "
        f"records")
    print(json.dumps({"kernels": kernels, "profiler_retries": retries}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_wgmma_sass(_lib) -> None:
    """The int8 tile body must be compiled to Hopper's asynchronous pipeline:
    its SASS (cuobjdump, beside nvcc) holds TMA loads (UTMALDG), mbarrier
    waits (SYNCS) and warpgroup MMAs (IGMMA or HGMMA)."""
    cuobjdump = Path(_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", _lib.BUILD_INFO["path"]],
                          capture_output=True, text=True, check=True).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if "int8_wgmma_kernel" in part.splitlines()[0]), None)
    if body is None:
        raise RuntimeError("chip_smoke: int8_wgmma_kernel not in the library")
    counts = {op: body.count(op) for op in ("UTMALDG", "SYNCS", "GMMA")}
    log(f"[build] int8_wgmma_kernel SASS: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"int8_wgmma_kernel lacks TMA / mbarrier / wgmma "
                           f"instructions: {counts}")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions at the serving shapes
# ---------------------------------------------------------------------------

def _record(results, name, case, err, tol, ms, plain_ms, lib_ms, bms, by,
            replaces, main_case):
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    earlier = EARLIER_MS.get(f"{name} {case}")
    earlier = "" if earlier is None else f" (PERF.md, earlier body: {earlier:.4f} ms)"
    log(f"[kernel] {name} {case}: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"kernel {ms:.4f} ms{earlier}, plain {plain_ms:.4f} ms, library {lib}, "
        f"bound {bms:.4f} ms ({by})")
    if not err <= tol:
        raise RuntimeError(f"{name} {case}: error {err} above tolerance {tol}")
    if main_case:
        results[name] = {"replaces": replaces, "max_abs_err": err, "tol": tol,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "shape": case}


def kv_cache_tensors(torch, gen, lead, hkv, d, kv_bits):
    """(k, v, k_scale, v_scale) cache rows ``lead`` on the card in format
    ``kv_bits``: float32; random int8 codes with float32 scales; or random
    nibble bytes with bf16 scales."""
    dev = "cuda"
    if kv_bits == 16:
        return tuple(torch.randn(lead + (hkv, d), generator=gen, device=dev)
                     for _ in range(2)) + (None, None)
    dk = d // 2 if kv_bits == 4 else d
    codes = lambda: torch.randint(-128, 128, lead + (hkv, dk), generator=gen,
                                  device=dev, dtype=torch.int8)
    if kv_bits == 8:
        sc = lambda: torch.rand(lead + (hkv,), generator=gen, device=dev) * 0.05 + 0.01
    else:
        sc = lambda: (torch.rand(lead + (hkv, d // 32), generator=gen, device=dev)
                      * 0.05 + 0.01).to(torch.bfloat16)
    return (codes(), codes(), sc(), sc())


def dequant(kv):
    """Float32 K and V of a cache tuple (the library yardstick's input)."""
    from repro_torch.kernels.flash_decode import dequant_tile
    return dequant_tile(kv[0], kv[2]), dequant_tile(kv[1], kv[3])


def kv_token_bytes(kv_bits: int, hkv: int, d: int) -> int:
    """Cache bytes of one position, K and V: 2 * (4 D) at kv16,
    2 * (D + 4) at kv8, 2 * (D / 2 + 2 D / 32) at kv4, per KV head."""
    per = {16: 4 * d, 8: d + 4, 4: d // 2 + 2 * (d // 32)}[kv_bits]
    return 2 * hkv * per


def check_kernels(torch, timer, results) -> None:
    import torch.nn.functional as F
    from repro_torch.core.packing import pack
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import int8_matmul as i8
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # ---- the two matmuls: every linear shape of llama-7b, decode + prefill
    g, bits = 128, 4
    for m, k, n in LINEAR_SHAPES:
        x = randn(m, k)
        codes = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                              dtype=torch.uint8)
        packed = pack(codes, bits)
        scale = torch.rand((k // g, n), generator=gen, device=dev) * 0.01 + 1e-3
        zp = torch.randint(0, 16, (k // g, n), generator=gen, device=dev
                           ).to(torch.float32)
        w = ((codes.to(torch.float32).reshape(k // g, g, n) - zp[:, None])
             * scale[:, None]).reshape(k, n)
        nbytes = (packed.numel() + 8 * scale.numel() + 4 * m * k + 4 * m * n)
        case = f"M={m} K={k} N={n} w4 g128"
        main = (m, k, n) == (4, 4096, 11008)
        lib_ms = timer(lambda: torch.matmul(x, w))

        want = i8.quant_matmul_plain(x, packed, scale, zp, bits=bits,
                                     group_size=g, a_bits=4)
        got = i8.w4a8_matmul(x, packed, scale, zp, bits=bits, group_size=g,
                             a_bits=4)
        _require_equal(torch, "w4a8_matmul", case + " a4", got, want)
        if m > 4:
            # rows do not depend on M: decode body (M = 4) vs tile body
            if not torch.equal(i8.w4a8_matmul(x[:4], packed, scale, zp,
                                              bits=bits, group_size=g,
                                              a_bits=4), got[:4]):
                raise RuntimeError(f"w4a8_matmul {k}->{n}: rows at M=4 "
                                   f"differ from the same rows at M={m}")
            log(f"[kernel] w4a8_matmul {k}->{n}: rows at M=4 equal the "
                f"first 4 rows at M={m} (bit-equal)")
        bms, by = bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
        def call():
            i8.w4a8_matmul(x, packed, scale, zp, bits=bits, group_size=g,
                           a_bits=4)
        dev_ms = timer(call, hide_host=True)
        ms = timer(call)
        host_ms = timer.host_ms
        _record(results, "w4a8_matmul", case + " a4", 0.0, 0.0, ms,
                timer(lambda: i8.quant_matmul_plain(
                    x, packed, scale, zp, bits=bits, group_size=g, a_bits=4),
                    reps=5),
                lib_ms, bms, by, "src/repro/kernels/int8_matmul.py:188", main)
        log(f"[kernel] w4a8_matmul {case} a4: {ms / lib_ms:.3f}x the time of "
            f"torch.matmul ({'faster' if ms < lib_ms else 'SLOWER'}); "
            f"device work alone {dev_ms:.4f} ms, host enqueue "
            f"{host_ms:.4f} ms a call")

        want = dq.dequant_matmul_plain(x, packed, scale, zp, bits=bits,
                                       group_size=g)
        got = dq.dequant_matmul(x, packed, scale, zp, bits=bits, group_size=g)
        if m > 4:
            # rows do not depend on M: decode body (M = 4) vs tile body
            if not torch.equal(dq.dequant_matmul(x[:4], packed, scale, zp,
                                                 bits=bits, group_size=g),
                               got[:4]):
                raise RuntimeError(f"dequant_matmul {k}->{n}: rows at M=4 "
                                   f"differ from the same rows at M={m}")
            log(f"[kernel] dequant_matmul {k}->{n}: rows at M=4 equal the "
                f"first 4 rows at M={m} (bit-equal)")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        bms, by = bound(nbytes, 2 * m * k * n, FP32_OPS_PER_S)
        _record(results, "dequant_matmul", case, err, tol,
                timer(lambda: dq.dequant_matmul(x, packed, scale, zp,
                                                bits=bits, group_size=g)),
                timer(lambda: dq.dequant_matmul_plain(
                    x, packed, scale, zp, bits=bits, group_size=g), reps=5),
                lib_ms, bms, by, "src/repro/kernels/dequant_matmul.py:80",
                main)
        del x, codes, packed, scale, zp, w, want, got

    # ---- attention over the llama-7b cache: B 4, S 512, D 128, and one
    # long context (S 2048, a 67 MB kv8 cache)
    b, s, d = 4, 512, 128

    def cache(hkv, kv_bits, s=s):
        return kv_cache_tensors(torch, gen, (b, s), hkv, d, kv_bits)

    for hkv, gq, kv_bits, lens, s in ((32, 1, 8, (144, 144, 144, 144), 512),
                                      (32, 1, 8, (0, 1, 257, 512), 512),
                                      (32, 1, 16, (144, 144, 144, 144), 512),
                                      (32, 1, 4, (144, 144, 144, 144), 512),
                                      (8, 4, 8, (0, 31, 300, 512), 512),
                                      (32, 1, 8, (2048,) * 4, 2048)):
        kv = cache(hkv, kv_bits, s)
        q = randn(b, hkv, gq, d)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, kv[0], kv[1], cur, kv[2], kv[3],
                                     block_kv=512)
        got = fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if any(x == 0 for x in lens) and got[cur == 0].any():
            raise RuntimeError("flash_decode: a cur_len == 0 row is not zero")
        # never a float copy of the cache: peak allocation below one fp32 K
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fp32_copy = b * s * hkv * d * 4
        log(f"[kernel] flash_decode peak extra memory {peak} B < one fp32 "
            f"cache copy {fp32_copy} B")
        if peak >= fp32_copy:
            raise RuntimeError("flash_decode materialised the cache")
        kf, vf = dequant(kv)
        kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
        qt = q.reshape(b, hkv * gq, 1, d)
        mask = (torch.arange(s, device=dev)[None, :] < cur[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        total = int(sum(lens))
        nbytes = total * kv_token_bytes(kv_bits, hkv, d) + 2 * q.numel() * 4 + 4 * b
        bms, by = bound(nbytes, 4 * d * gq * hkv * total, FP32_OPS_PER_S)
        case = (f"B={b} S={s} Hkv={hkv} G={gq} D={d} "
                f"kv{kv_bits} cur_len={list(lens)}")
        main = kv_bits == 8 and gq == 1 and lens[0] == 144
        _record(results, "flash_decode", case, err, tol,
                timer(lambda: fd.flash_decode(q, kv[0], kv[1], cur, kv[2], kv[3])),
                timer(lambda: fd.flash_decode_plain(
                    q, kv[0], kv[1], cur, kv[2], kv[3], block_kv=512), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_decode.py:129", main)

    del kv, q, kf, vf, kt, vt
    c = 128
    for hkv, gq, kv_bits, offs, cls, sc in (
            (32, 1, 8, (0, 0, 0, 0), (128, 128, 128, 128), 128),
            (32, 1, 8, (0, 5, 300, 0), (128, 0, 77, 3), 512),
            (32, 1, 16, (0, 0, 0, 0), (128, 128, 128, 128), 128),
            (32, 1, 4, (0, 0, 0, 0), (128, 128, 128, 128), 128),
            (8, 4, 8, (0, 40, 384, 0), (128, 100, 128, 0), 512)):
        kv = cache(hkv, kv_bits)
        kv = tuple(None if t is None else t[:, :sc].contiguous() for t in kv)
        q = randn(b, hkv, c, gq, d)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cl = torch.tensor(cls, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_plain(q, kv[0], kv[1], off, cl, kv[2], kv[3],
                                      block_kv=min(512, sc))
        got = fp.flash_prefill(q, kv[0], kv[1], off, cl, kv[2], kv[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        kf, vf = dequant(kv)
        kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
        qt = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * gq, c, d)
        rows = torch.arange(c, device=dev)
        mask = ((torch.arange(sc, device=dev)[None, None, :]
                 <= off[:, None, None] + rows[None, :, None])
                & (rows[None, :, None] < cl[:, None, None]))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        attended = sum(min(o + x + 1, sc) for o, n in zip(offs, cls)
                       for x in range(n))
        prefix = sum(min(o + n, sc) for o, n in zip(offs, cls) if n)
        nbytes = prefix * kv_token_bytes(kv_bits, hkv, d) + 2 * q.numel() * 4 + 8 * b
        bms, by = bound(nbytes, 4 * d * gq * hkv * attended, FP32_OPS_PER_S)
        case = (f"B={b} C={c} S={sc} Hkv={hkv} G={gq} D={d} "
                f"kv{kv_bits} offset={list(offs)} chunk_len={list(cls)}")
        main = kv_bits == 8 and gq == 1 and cls[1] == 128
        _record(results, "flash_prefill", case, err, tol,
                timer(lambda: fp.flash_prefill(q, kv[0], kv[1], off, cl,
                                               kv[2], kv[3])),
                timer(lambda: fp.flash_prefill_plain(
                    q, kv[0], kv[1], off, cl, kv[2], kv[3],
                    block_kv=min(512, sc)), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_prefill.py:143",
                main)

    # the resume contract on the card: a one-token chunk is decode
    kv = cache(32, 8)
    q = randn(b, 1, 32, d)
    cur = torch.tensor([1, 100, 257, 512], dtype=torch.int32, device=dev)
    from repro_torch.kernels import ops
    if not torch.equal(ops.flash_decode(q, kv, cur),
                       ops.flash_prefill(q, kv, cur - 1, torch.ones_like(cur))):
        raise RuntimeError("a one-token flash_prefill chunk differs from "
                           "flash_decode")
    log("[kernel] one-token flash_prefill == flash_decode (bit-equal)")
    check_chunk_split(torch, "flash_prefill", gen, lambda kv, o, n, qq:
                      fp.flash_prefill(qq, kv[0], kv[1], o, n, kv[2], kv[3]),
                      lambda kv_bits: cache(32, kv_bits))


def check_chunk_split(torch, name, gen, call, make_cache) -> None:
    """Raise unless a chunk split in two equals the whole chunk bit for bit
    (llama-7b: B 4, Hkv 32, G 1, D 128, C 128, ragged offsets and lengths
    including 0; splits after 37 and 64 tokens), kv16/kv8/kv4."""
    dev = "cuda"
    off = torch.tensor([0, 64, 300, 17], dtype=torch.int32, device=dev)
    cl = torch.tensor([128, 100, 0, 1], dtype=torch.int32, device=dev)
    for kv_bits in (16, 8, 4):
        kv = make_cache(kv_bits)
        q = torch.randn((4, 32, 128, 1, 128), generator=gen, device=dev)
        whole = call(kv, off, cl, q)
        for c1 in (37, 64):
            first = call(kv, off, torch.clamp(cl, max=c1),
                         q[:, :, :c1].contiguous())
            second = call(kv, off + c1, torch.clamp(cl - c1, min=0),
                          q[:, :, c1:].contiguous())
            if not torch.equal(torch.cat([first, second], 2), whole):
                raise RuntimeError(f"{name} kv{kv_bits}: two chunks split "
                                   f"after {c1} tokens differ from the whole")
    log(f"[kernel] {name}: two chunks == the whole chunk (bit-equal, "
        f"kv16/kv8/kv4, splits after 37 and 64 tokens)")


def paged_case(torch, gen, lens, hkv, d, ps, kv_bits, max_pages):
    """Pools for ``max_pages`` pages per sequence, a shuffled page table
    holding ceil(len / ps) pages per row and -1 past them, and the linear
    cache the table spells out (same contents, -1 reading page 0)."""
    b = len(lens)
    num_pages = b * max_pages
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(
        ps + kv_bits + hkv))
    pt = torch.full((b, max_pages), -1, dtype=torch.int32)
    used = 0
    for row, n in enumerate(lens):
        k = -(-n // ps)
        pt[row, :k] = perm[used:used + k].to(torch.int32)
        used += k
    pt = pt.cuda()
    pools = kv_cache_tensors(torch, gen, (num_pages, ps), hkv, d, kv_bits)
    idx = pt.long().clamp_min(0)
    lin = tuple(None if e is None else
                e[idx].reshape(b, -1, *e.shape[2:]).contiguous()
                for e in pools)
    return pools, pt, lin


def check_paged_kernels(torch, timer, results) -> None:
    """The paged kernels at llama-7b shapes (B 4, Hkv 32, G 1, D 128, pages
    of 64, a pool of 8 pages per sequence for max_len 512, a shuffled page
    table with -1 tails), each against its plain version and bit for bit
    against its linear kernel on the same contents."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    b, d, max_len = 4, 128, 512

    def sdpa_kv(lin):
        return tuple(t.transpose(1, 2) for t in dequant(lin))

    for hkv, gq, kv_bits, ps, lens, max_len in (
            (32, 1, 8, 64, (144, 144, 144, 144), 512),
            (32, 1, 16, 64, (144, 144, 144, 144), 512),
            (32, 1, 4, 64, (144, 144, 144, 144), 512),
            (32, 1, 8, 64, (0, 1, 257, 512), 512),
            (8, 4, 8, 64, (0, 31, 300, 512), 512),
            (32, 1, 8, 16, (0, 17, 144, 512), 512),
            (32, 1, 4, 16, (0, 17, 144, 512), 512),
            (32, 1, 8, 64, (2048,) * 4, 2048)):
        max_pages = max_len // ps
        pools, pt, lin = paged_case(torch, gen, lens, hkv, d, ps, kv_bits,
                                    max_pages)
        q = torch.randn((b, hkv, gq, d), generator=gen, device=dev)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = fd.flash_decode_paged_plain(q, pools[0], pools[1], pt, cur,
                                           *pools[2:])
        got = fd.flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if not torch.equal(got, fd.flash_decode(q, lin[0], lin[1], cur,
                                                *lin[2:])):
            raise RuntimeError(f"flash_decode_paged kv{kv_bits} page {ps}: "
                               f"differs from flash_decode on the same "
                               f"contents")
        if got[cur == 0].any():
            raise RuntimeError("flash_decode_paged: a cur_len == 0 row is "
                               "not zero")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fd.flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fp32_copy = b * max_len * hkv * d * 4
        if peak >= fp32_copy:
            raise RuntimeError("flash_decode_paged materialised the cache")
        kt, vt = sdpa_kv(lin)
        qt = q.reshape(b, hkv * gq, 1, d)
        mask = (torch.arange(kt.shape[2], device=dev)[None, :]
                < cur[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        total = int(sum(lens))
        pages_read = sum(-(-n // ps) for n in lens)
        nbytes = (total * kv_token_bytes(kv_bits, hkv, d) + 4 * pages_read
                  + 2 * q.numel() * 4 + 4 * b)
        bms, by = bound(nbytes, 4 * d * gq * hkv * total, FP32_OPS_PER_S)
        case = (f"B={b} pages of {ps}, {max_pages}/seq, Hkv={hkv} G={gq} "
                f"D={d} kv{kv_bits} cur_len={list(lens)}")
        log(f"[kernel] flash_decode_paged {case}: equals flash_decode bit "
            f"for bit; peak extra memory {peak} B < {fp32_copy} B")
        main = kv_bits == 8 and gq == 1 and ps == 64 and lens[0] == 144
        _record(results, "flash_decode_paged", case, err, tol,
                timer(lambda: fd.flash_decode_paged(q, pools[0], pools[1], pt,
                                                    cur, *pools[2:])),
                timer(lambda: fd.flash_decode_paged_plain(
                    q, pools[0], pools[1], pt, cur, *pools[2:]), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_decode.py:216",
                main)

    del pools, lin, q, kt, vt
    max_len = 512
    c = 128
    for hkv, gq, kv_bits, ps, offs, cls in (
            (32, 1, 8, 64, (0, 0, 0, 0), (128, 128, 128, 128)),
            (32, 1, 16, 64, (0, 0, 0, 0), (128, 128, 128, 128)),
            (32, 1, 4, 64, (0, 0, 0, 0), (128, 128, 128, 128)),
            (32, 1, 8, 64, (0, 5, 300, 0), (128, 0, 77, 3)),
            (8, 4, 8, 64, (0, 40, 384, 0), (128, 100, 128, 0)),
            (32, 1, 8, 16, (0, 21, 384, 64), (128, 1, 128, 0)),
            (32, 1, 4, 16, (0, 21, 384, 64), (128, 1, 128, 0))):
        max_pages = max_len // ps
        ends = [o + n for o, n in zip(offs, cls)]
        pools, pt, lin = paged_case(torch, gen, ends, hkv, d, ps, kv_bits,
                                    max_pages)
        q = torch.randn((b, hkv, c, gq, d), generator=gen, device=dev)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cl = torch.tensor(cls, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_paged_plain(q, pools[0], pools[1], pt, off,
                                            cl, *pools[2:])
        got = fp.flash_prefill_paged(q, pools[0], pools[1], pt, off, cl,
                                     *pools[2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5 * max(want.abs().max().item(), 1.0)
        if not torch.equal(got, fp.flash_prefill(q, lin[0], lin[1], off, cl,
                                                 *lin[2:])):
            raise RuntimeError(f"flash_prefill_paged kv{kv_bits} page {ps}: "
                               f"differs from flash_prefill on the same "
                               f"contents")
        kt, vt = sdpa_kv(lin)
        qt = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * gq, c, d)
        rows = torch.arange(c, device=dev)
        mask = ((torch.arange(kt.shape[2], device=dev)[None, None, :]
                 <= off[:, None, None] + rows[None, :, None])
                & (rows[None, :, None] < cl[:, None, None]))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=gq > 1))
        attended = sum(o + x + 1 for o, n in zip(offs, cls) for x in range(n))
        prefix = sum(e for e, n in zip(ends, cls) if n)
        pages_read = sum(-(-e // ps) for e, n in zip(ends, cls) if n)
        nbytes = (prefix * kv_token_bytes(kv_bits, hkv, d) + 4 * pages_read
                  + 2 * q.numel() * 4 + 8 * b)
        bms, by = bound(nbytes, 4 * d * gq * hkv * attended, FP32_OPS_PER_S)
        case = (f"B={b} C={c} pages of {ps}, {max_pages}/seq, Hkv={hkv} "
                f"G={gq} D={d} kv{kv_bits} offset={list(offs)} "
                f"chunk_len={list(cls)}")
        log(f"[kernel] flash_prefill_paged {case}: equals flash_prefill bit "
            f"for bit")
        main = kv_bits == 8 and gq == 1 and ps == 64 and cls[1] == 128
        _record(results, "flash_prefill_paged", case, err, tol,
                timer(lambda: fp.flash_prefill_paged(q, pools[0], pools[1],
                                                     pt, off, cl, *pools[2:])),
                timer(lambda: fp.flash_prefill_paged_plain(
                    q, pools[0], pools[1], pt, off, cl, *pools[2:]), reps=5),
                lib_ms, bms, by, "src/repro/kernels/flash_prefill.py:239",
                main)

    # the resume contract over pages: a one-token paged chunk is decode
    for kv_bits in (16, 8, 4):
        lens = (1, 64, 65, 512)
        pools, pt, _ = paged_case(torch, gen, lens, 32, d, 64, kv_bits, 8)
        q = torch.randn((b, 1, 32, d), generator=gen, device=dev)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        if not torch.equal(
                ops.flash_decode(q, pools, cur, page_table=pt),
                ops.flash_prefill(q, pools, cur - 1, torch.ones_like(cur),
                                  page_table=pt)):
            raise RuntimeError(f"kv{kv_bits}: a one-token flash_prefill_paged "
                               f"chunk differs from flash_decode_paged")
    log("[kernel] one-token flash_prefill_paged == flash_decode_paged "
        "(bit-equal, kv16/kv8/kv4)")
    # pages of 64, 8 per sequence, holding positions up to 428
    check_chunk_split(
        torch, "flash_prefill_paged", gen,
        lambda kv, o, n, qq: fp.flash_prefill_paged(qq, kv[0][0], kv[0][1],
                                                    kv[1], o, n, *kv[0][2:]),
        lambda kv_bits: paged_case(torch, gen, (128, 192, 300, 18), 32, d, 64,
                                   kv_bits, 8)[:2])


def _require_equal(torch, name, case, got, want) -> None:
    """Raise unless a kernel's result equals its plain version's bit for
    bit."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"{name} {case}: differs from its plain version")


def check_int8_kernels(torch, timer, results) -> None:
    """int8_matmul and w8a8_matmul at llama-7b's linear shapes and the
    512-token 4096 -> 4096 prefill on seeded int8 codes and positive
    per-channel scales, each bit-equal to its plain version, and rows at
    M = 4 (decode body) bit-equal to the same rows at M = 512 (wgmma body).
    Each log line names the body that ran, the time PERF.md recorded for
    the earlier body, the device work alone (also with the L2 left clean)
    and the host enqueue per call.
    Library yardstick: torch.matmul on the float32 operands with the
    scales folded in (and torch._int_mm at M = 512, logged)."""
    from repro_torch.kernels import int8_matmul as i8
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    for m, k, n in LINEAR_SHAPES + ((512, 4096, 4096),):
        x = torch.randn((m, k), generator=gen, device=dev)
        x_q = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                            dtype=torch.int8)
        x_scale = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 0.01
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        w_scale = torch.rand((n,), generator=gen, device=dev) * 0.05 + 0.01
        w_f = w_q.to(torch.float32) * w_scale
        x_f = x_q.to(torch.float32) * x_scale
        case = f"M={m} K={k} N={n}"
        main = (m, k, n) == (4, 4096, 11008)
        n_ops = 2 * m * k * n
        int_mm_ms = (timer(lambda: torch._int_mm(x_q, w_q)) if m > 16
                     else None)
        for name, call, plain, lib_call, nbytes, body in (
                ("int8_matmul",
                 lambda: i8.int8_matmul(x_q, x_scale, w_q, w_scale),
                 lambda: i8.int8_matmul_plain(x_q, x_scale, w_q, w_scale),
                 lambda: torch.matmul(x_f, w_f),
                 m * k + 4 * m + k * n + 4 * n + 4 * m * n,
                 i8.int8_body(x_q, w_q)),
                ("w8a8_matmul",
                 lambda: i8.w8a8_matmul(x, w_q, w_scale),
                 lambda: i8.w8a8_dynamic_plain(x, w_q, w_scale),
                 lambda: torch.matmul(x, w_f),
                 4 * m * k + k * n + 4 * n + 4 * m * n,
                 i8.w8a8_body(x, w_q))):
            got = call()
            _require_equal(torch, name, case, got, plain())
            if m > 4:
                # rows do not depend on M: decode body (M = 4) vs this one
                if name == "int8_matmul":
                    four = i8.int8_matmul(x_q[:4], x_scale[:4], w_q, w_scale)
                else:
                    four = i8.w8a8_matmul(x[:4], w_q, w_scale)
                _require_equal(torch, name, f"{case} rows 0-3 at M=4",
                               four, got[:4])
                log(f"[kernel] {name} {k}->{n}: rows at M=4 equal the first "
                    f"4 rows at M={m} (bit-equal)")
            bms, by = bound(nbytes, n_ops, INT8_OPS_PER_S)
            lib_ms = timer(lib_call)
            dev_ms = timer(call, hide_host=True)
            clean_ms = timer(call, hide_host=True, clean_l2=True)
            ms = timer(call)
            host_ms = timer.host_ms
            _record(results, name, case, 0.0, 0.0, ms,
                    timer(plain, reps=5), lib_ms, bms, by,
                    "src/repro/kernels/int8_matmul.py:"
                    + ("58" if name == "int8_matmul" else "111"), main)
            vs = f"{ms / lib_ms:.3f}x the time of torch.matmul"
            if int_mm_ms is not None:
                vs += (f", {ms / int_mm_ms:.3f}x torch._int_mm's "
                       f"{int_mm_ms:.4f} ms (int32 product only)")
            log(f"[kernel] {name} {case}: {body} body; {vs}; device work "
                f"alone {dev_ms:.4f} ms ({clean_ms:.4f} ms after a read-only "
                f"flush), host enqueue {host_ms:.4f} ms a call")
        del x, x_q, x_scale, w_q, w_scale, w_f, x_f


def check_quantize_pack(torch, timer, results) -> None:
    """quantize_pack at llama-7b's weight shapes (w4 g128 both ways, then
    w2, w8 and per-channel w4 on 4096 x 11008): packed bytes, scales and
    zero points equal to the plain version's.  No single PyTorch call
    computes it, so it has no library time.  Bound: 4 K N bytes read and
    K N bits / 8 + 8 N K / g written, or 7 float32 operations an element
    (max, min, quotient, round, add, two clamps)."""
    from repro_torch.kernels import quantize_pack as qp
    gen = torch.Generator(device="cuda").manual_seed(3)
    for k, n, bits, g in ((4096, 11008, 4, 128), (11008, 4096, 4, 128),
                          (4096, 11008, 2, 128), (4096, 11008, 8, 128),
                          (4096, 11008, 4, 0)):
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        case = f"K={k} N={n} w{bits} g{g}"
        got = qp.quantize_pack(w, bits=bits, group_size=g)
        want = qp.quantize_pack_plain(w, bits, g)
        for a, b in zip(got, want):
            _require_equal(torch, "quantize_pack", case, a, b)
        gs = g or k
        bms, by = bound(4 * k * n + k * n * bits // 8 + 8 * n * (k // gs),
                        7 * k * n, FP32_OPS_PER_S)
        _record(results, "quantize_pack", case, 0.0, 0.0,
                timer(lambda: qp.quantize_pack(w, bits=bits, group_size=g)),
                timer(lambda: qp.quantize_pack_plain(w, bits, g), reps=5),
                None, bms, by, "src/repro/kernels/quantize_pack.py:115",
                (k, n, bits, g) == (4096, 11008, 4, 128))
        del w, got, want


# ---------------------------------------------------------------------------
# 3. serving llama-7b W4A4 kv8 at full width
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "llama-7b", "--wbits", "4", "--group", "128",
              "--abits", "4", "--kvbits", "8", "--requests", "4",
              "--prompt-len", "128", "--max-new", "32", "--max-batch", "4",
              "--max-len", "512", "--seed", "0", "--device", "cuda"]
# Per-block teacher-forced check: a token row agrees when its largest
# difference is within ROW_TOL of its largest magnitude (a few float32
# ulps); a row whose a4 code an attention ulp moved differs by ~1e-2..1e-1.
# Such rows are rare (an ulp sits within reach of a rounding boundary for
# about one element in a million); a wrong kernel would fail most rows.
ROW_TOL = 1e-5
ROW_SHARE = 0.9
# a16 end-to-end: no rounding step between the kernels, so only float32
# summation order differs.
A16_TOL = 1e-3


def serve_w4a4(torch, params) -> tuple[dict, list, "torch.Tensor"]:
    """Phase 3; returns the launch counts, the greedy streams and the
    prompts (4, 128)."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(LAYERS)])
    if LAYERS != 32:
        log(f"[serve] depth cut to {LAYERS} of 32 layers")
    _lib.reset_launches()
    out = serve.serve(args, params)
    counts = dict(_lib.LAUNCHES)
    log(f"[serve] {out['cfg'].name} x{LAYERS} w4a4 g128 kv8: {out['generated']} "
        f"tokens in {out['seconds']:.3f} s = {out['tokens_per_s']:.2f} tok/s "
        f"(prefill of 4x128 included)")
    steps = out["step_seconds"]
    log(f"[serve] first step (admission + prefill + one decode) "
        f"{steps[0]:.4f} s; decode step median "
        f"{statistics.median(steps[1:]) * 1e3:.2f} ms over "
        f"{len(steps) - 1} steps (weight-stream bound per step 1.24 ms)")
    log(f"[serve] weight bytes {out['weight_bytes']}, KV bytes "
        f"{out['kv_bytes']}, launches {counts}")
    for name in ("w4a8_matmul", "flash_prefill", "flash_decode"):
        if counts[name] <= 0:
            raise RuntimeError(f"{name} not launched on the W4A4 path")
    reqs = out["requests"]
    vocab = out["cfg"].vocab_size
    if any(len(r.out_tokens) != 32 or not all(0 <= t < vocab
                                              for t in r.out_tokens)
           for r in reqs):
        raise RuntimeError("serve: a request did not produce 32 valid tokens")

    # teacher-forced checks against the plain versions on the card
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in reqs], dtype=torch.int32)
    gate_blockwise(torch, "serve", out, prompts, gen)
    a, p = teacher_forced_logits(torch, out, prompts, gen)
    if not (torch.isfinite(a).all() and a.shape == (4, 9, vocab)):
        raise RuntimeError("serve: non-finite or misshaped logits")
    rel = ((a - p).abs().max() / p.abs().max()).item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    stream = (a[:, :8].argmax(-1).cpu() == gen[:, :8]).float().mean().item()
    log(f"[serve] end-to-end teacher-forced logits, kernels vs plain over "
        f"{LAYERS} a4 layers: max|dlogit| / max|logit| {rel:.3e}, greedy "
        f"agreement {agree:.4f} (reported, not gated: a4 rounding amplifies "
        f"ulp differences layer over layer); engine stream vs "
        f"teacher-forced kernel argmax {stream:.4f}")
    if stream != 1.0:
        raise RuntimeError("serve: the engine's stream differs from the "
                           "teacher-forced kernel path")
    streams = [list(r.out_tokens) for r in reqs]
    del out, a, p
    torch.cuda.empty_cache()
    return counts, streams, prompts


def gate_blockwise(torch, tag, out, prompts, gen, **paged) -> None:
    """The per-block teacher-forced check, logged and gated at ROW_SHARE."""
    share, n_rows, worst = blockwise_check(torch, out, prompts, gen, **paged)
    log(f"[{tag}] per-block teacher-forced kernels vs plain (prefill + 8 "
        f"decode steps, every layer): {share['block']:.4f} of "
        f"{n_rows['block']} block-output token rows and {share['logit']:.4f} "
        f"of {n_rows['logit']} logit rows agree to {ROW_TOL:.0e} (gate "
        f"{ROW_SHARE} each); largest row difference {worst[0]:.3e} at "
        f"{worst[1]}")
    if not min(share.values()) >= ROW_SHARE:
        raise RuntimeError(f"{tag}: blocks of the kernel path disagree with "
                           f"the plain versions")


def teacher_forced_logits(torch, out, prompts, gen, steps: int = 8):
    """Prefill logits and ``steps`` teacher-forced decode steps through the
    kernels (mode "auto") and through the plain versions."""
    from repro_torch.launch.serve import teacher_forced
    from repro_torch.serve.quantized import QuantizedModel
    return [teacher_forced(QuantizedModel(out["cfg"], out["qcfg"], mode=mode,
                                          device=out["model"].device),
                           out["params"], prompts, gen, steps, 512)
            for mode in ("auto", "plain")]


def blockwise_check(torch, out, prompts, gen, steps: int = 8,
                    page_size: int = 0, chunk: int = 0):
    """Every block of the kernel path, fed the plain path's input hidden
    state, against the plain block: prefill (whole, or in chunks of
    ``chunk`` rows), then ``steps`` teacher-forced decode steps, over the
    linear cache or (``page_size``) over page pools with identical page
    tables.  The integer matmul kernel is bit-equal to its plain version,
    so both paths write identical K/V and the caches stay equal; only the
    attention kernels' summation order differs.  A token row therefore
    comes out equal to a few ulps, unless such an ulp moved one of its a4
    activation codes by one step, which changes that row by up to ~10%.
    Returns (share of rows agreeing to ROW_TOL, rows, (largest row
    difference, where))."""
    from repro_torch.serve import kv_cache as kvc
    from repro_torch.models.init import layer
    from repro_torch.serve.quantized import QuantizedModel
    cfg, params = out["cfg"], out["params"]
    dev = out["model"].device
    models = [QuantizedModel(cfg, out["qcfg"], mode=m, device=dev)
              for m in ("auto", "plain")]
    tokens = prompts.to(dev)
    b, t = tokens.shape
    pt = None
    if page_size:
        stores = [kvc.PagedCache(m, b, 512, page_size) for m in models]
        for st in stores:
            for slot in range(b):
                if not st.reserve(slot, t + steps):
                    raise RuntimeError("blockwise_check: pool too small")
        caches = [st.cache for st in stores]
        pt = caches[0].page_table
        if not torch.equal(pt, caches[1].page_table):
            raise RuntimeError("blockwise_check: page tables differ")
        rows = caches[0].num_pages * page_size
    else:
        caches = [m.init_cache(b, 512) for m in models]
    stats = {k: {"agree": 0, "rows": 0} for k in ("block", "logit")}
    worst = [0.0, ""]

    def compare(ya, yp, where, kind="block"):
        d = (ya - yp).abs().amax(-1).flatten()
        rel = d / yp.abs().amax(-1).flatten()
        stats[kind]["agree"] += int((rel <= ROW_TOL).sum())
        stats[kind]["rows"] += rel.numel()
        r = rel.max().item()
        if not r <= worst[0]:
            worst[:] = [r, where]

    def logits(ya, yp, where):
        compare(models[0]._head(params, ya), models[1]._head(params, yp),
                where + " logits", "logit")

    chunk = chunk or t
    for c0 in range(0, t, chunk):
        c = min(chunk, t - c0)
        offset = torch.full((b,), c0, dtype=torch.int32, device=dev)
        cl = torch.full((b,), c, dtype=torch.int32, device=dev)
        pos = offset[:, None] + torch.arange(c, device=dev)[None]
        if page_size:
            write = kvc.paged_chunk_write_index(kvc.chunk_write_dest(
                pt, offset, cl, c, page_size, rows // page_size), rows)
        else:
            write = kvc.chunk_write_index(offset, cl, c, 512)
        x = params["embed"][tokens[:, c0:c0 + c].long()]
        for i in range(cfg.num_layers):
            lp = layer(params["layers"], i)
            ya, yp = (m._block_prefill_chunk(lp, x, m._kv_entries(cc, i), pos,
                                             offset, cl, write, pt)
                      for m, cc in zip(models, caches))
            compare(ya, yp, f"prefill rows {c0}.. layer {i}")
            x = yp
    logits(ya[:, -1:], yp[:, -1:], "prefill")
    cur = torch.full((b,), t, dtype=torch.int32, device=dev)
    for step in range(steps):
        x = params["embed"][gen[:, step:step + 1].to(dev).long()]
        if page_size:
            write = kvc.token_write_index(kvc.token_write_dest(
                pt, cur, page_size, rows // page_size), rows)
        for i in range(cfg.num_layers):
            lp = layer(params["layers"], i)
            if page_size:
                ya, yp = (m._block_decode_paged(
                    lp, x, m._kv_entries(cc, i), cur, pt, write,
                    cc.capacity) for m, cc in zip(models, caches))
            else:
                ya, yp = (m._block_decode(lp, x, m._kv_entries(cc, i), cur)
                          for m, cc in zip(models, caches))
            compare(ya, yp, f"decode step {step} layer {i}")
            x = yp
        logits(ya, yp, f"decode step {step}")
        cur = cur + 1
    same = all(torch.equal(a, p) for a, p in zip(
        models[0]._kv_entries(caches[0], slice(None)),
        models[1]._kv_entries(caches[1], slice(None))))
    if not same:
        raise RuntimeError("the kernel and plain paths wrote different K/V")
    return ({k: v["agree"] / v["rows"] for k, v in stats.items()},
            {k: v["rows"] for k, v in stats.items()}, tuple(worst))


def serve_a16(torch) -> dict:
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    argv = [a for a in SERVE_ARGS]
    argv[argv.index("--abits") + 1] = "16"
    argv[argv.index("--kvbits") + 1] = "16"
    argv[argv.index("--max-new") + 1] = "8"
    args = serve.build_parser().parse_args(argv + ["--layers",
                                                   str(A16_LAYERS)])
    _lib.reset_launches()
    out = serve.serve(args)
    counts = dict(_lib.LAUNCHES)
    log(f"[serve-a16] {out['cfg'].name} x{A16_LAYERS} (depth cut) w4a16 g128 kv16: "
        f"{out['generated']} tokens in {out['seconds']:.3f} s = "
        f"{out['tokens_per_s']:.2f} tok/s; launches {counts}")
    if counts["dequant_matmul"] <= 0 or counts["w4a8_matmul"] != 0:
        raise RuntimeError("the a16 path did not run dequant_matmul alone")
    import numpy as np
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in out["requests"]],
                       dtype=torch.int32)
    a, p = teacher_forced_logits(torch, out, prompts, gen)
    rel = ((a - p).abs().max() / p.abs().max()).item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    log(f"[serve-a16] teacher-forced logits (prefill + 8 decode steps), "
        f"kernels vs plain: max|dlogit| / max|logit| {rel:.3e} (tol "
        f"{A16_TOL:.0e}); greedy agreement {agree:.4f}")
    if not (torch.isfinite(a).all() and rel <= A16_TOL):
        raise RuntimeError("serve-a16: kernels and plain versions disagree")
    del out
    torch.cuda.empty_cache()
    return counts


def _with(argv: list, **flags) -> list:
    """SERVE_ARGS with ``--flag value`` pairs replaced or added
    (``value is True`` adds a bare switch)."""
    argv = list(argv)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if value is True:
            argv.append(flag)
        elif flag in argv:
            argv[argv.index(flag) + 1] = str(value)
        else:
            argv += [flag, str(value)]
    return argv


def _serve_paged_run(torch, tag, params, **flags):
    """One paged serving run through the CLI's entry point; returns the
    output and its launch counts."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        _with(SERVE_ARGS, layers=LAYERS, paged=True, **flags))
    _lib.reset_launches()
    out = serve.serve(args, params)
    counts = dict(_lib.LAUNCHES)
    kv = out["engine"]._kv
    steps = out["step_seconds"]
    log(f"[{tag}] {out['cfg'].name} x{LAYERS} {out['qcfg'].tag()} paged "
        f"(page {args.page_size}, {kv.allocator.num_pages} pages, prefill "
        f"chunk {args.prefill_chunk or 'whole prompt'}): {out['generated']} "
        f"tokens in {out['seconds']:.3f} s = {out['tokens_per_s']:.2f} tok/s; "
        f"decode step median {statistics.median(steps[1:]) * 1e3:.2f} ms over "
        f"{len(steps) - 1} steps; preemptions {out['preemptions']}")
    log(f"[{tag}] pool bytes {kv.cache.pool_bytes} (KV bytes with page "
        f"tables and lens {out['kv_bytes']}); peak pages in use "
        f"{kv.allocator.peak_in_use}; launches {counts}")
    bad = [r.rid for r in out["requests"]
           if r.status.name != "COMPLETED" or len(r.out_tokens) != args.max_new]
    if bad:
        raise RuntimeError(f"{tag}: requests {bad} did not complete with "
                           f"{args.max_new} tokens")
    kv.verify()
    if kv.allocator.num_free != kv.allocator.num_pages:
        raise RuntimeError(f"{tag}: pages leaked")
    return out, counts


def serve_paged(torch, params, base_streams) -> dict:
    """Phase 5: the phase-3 model and requests over page pools; (a) whole
    prompts into an automatic pool, (b) chunks of 64 into a 10-page pool."""
    import numpy as np
    out, counts = _serve_paged_run(torch, "paged-a", params, page_size=64)
    streams = [r.out_tokens for r in out["requests"]]
    if counts["flash_decode_paged"] <= 0 or counts["flash_decode"] != 0:
        raise RuntimeError("paged-a: decode did not run flash_decode_paged "
                           "alone")
    if streams != base_streams:
        raise RuntimeError("paged-a: the paged streams differ from the "
                           "linear streams of phase 3")
    log("[paged-a] greedy streams equal phase 3's linear streams token for "
        "token")
    del out
    out, counts_b = _serve_paged_run(torch, "paged-b", params, page_size=64,
                                     prefill_chunk=64, num_pages=10)
    if out["preemptions"] < 1:
        raise RuntimeError("paged-b: the 10-page pool never preempted")
    for name in ("flash_prefill_paged", "flash_decode_paged"):
        if counts_b[name] <= 0:
            raise RuntimeError(f"paged-b: {name} was never launched")
    if out["engine"]._kv.cache.pool_bytes != 173_015_040:
        raise RuntimeError("paged-b: the kv8 pool is not 10 pages x 64 x "
                           "8,448 B x 32 layers")
    streams_b = [r.out_tokens for r in out["requests"]]
    same = sum(a == b for s, t in zip(streams_b, base_streams)
               for a, b in zip(s, t))
    log(f"[paged-b] streams vs phase 3: {same} of {32 * len(base_streams)} "
        f"tokens equal, {sum(s == t for s, t in zip(streams_b, base_streams))} "
        f"of {len(base_streams)} streams identical (reported, not gated: "
        f"chunked and resumed prefill change the row count of float "
        f"reductions, and at a4 an ulp can move a code)")
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor(streams_b, dtype=torch.int32)
    gate_blockwise(torch, "paged-b", out, prompts, gen, page_size=64,
                   chunk=64)
    for name, n in counts_b.items():
        counts[name] += n
    del out
    torch.cuda.empty_cache()
    return counts


def serve_kv4(torch, params) -> dict:
    """Phase 6: the phase-3 model at kv4 over page pools, chunked."""
    import numpy as np
    out, counts = _serve_paged_run(torch, "kv4", params, kvbits=4,
                                   max_new=8, page_size=64, prefill_chunk=64)
    for name in ("flash_prefill_paged", "flash_decode_paged"):
        if counts[name] <= 0:
            raise RuntimeError(f"kv4: {name} was never launched")
    kv = out["engine"]._kv
    per_token = kv.cache.pool_bytes // (kv.allocator.num_pages * 64 * LAYERS)
    log(f"[kv4] pool bytes per token per layer {per_token} (kv8: 8448)")
    if per_token != 4608:
        raise RuntimeError("kv4: the pool is not 4,608 B per token per layer")
    prompts = torch.from_numpy(np.stack(out["prompts"]))
    gen = torch.tensor([r.out_tokens for r in out["requests"]],
                       dtype=torch.int32)
    gate_blockwise(torch, "kv4", out, prompts, gen, page_size=64, chunk=64)
    del out
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 7. the three kernels no serving path runs, over the served tree
# ---------------------------------------------------------------------------

def device_kernels(torch, fn, want, tries: int = 3) -> tuple[list, int]:
    """The names of the device kernels one call of ``fn`` runs
    (torch.profiler), and how many traces were taken again.  Every traced
    call must return ``want`` bit for bit.  The profiler at times loses a
    trace's device records (``python -m repro_torch.launch.card_probe``
    counts how often): the trace holds no device event while its CPU side
    holds the kernel launch (``cudaLaunchKernel`` /
    ``cudaLaunchKernelExC``), the wrapper counted it and the output is
    bit-equal.  Only such a trace is taken again, up to ``tries`` times;
    an empty trace with no launch call fails."""
    from torch.autograd import DeviceType
    act = torch.profiler.ProfilerActivity
    for retry in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            got = fn()
            torch.cuda.synchronize()
        if not torch.equal(got.reshape(want.shape), want):
            raise RuntimeError("repack: a traced call differs from the "
                               "plain version")
        events = prof.events()
        names = [e.name for e in events if e.device_type == DeviceType.CUDA]
        if names:
            return names, retry
        if not any(re.match(r"cu(da)?LaunchKernel", e.name) for e in events):
            raise RuntimeError("repack: a traced call launched no kernel")
        log("[repack] the profiler lost the device records of a launch; "
            "tracing again")
    raise RuntimeError(f"repack: {tries} traces in a row lost their device "
                       f"records")


def repack(torch, params, prompts) -> tuple[dict, int]:
    """Phase 7 (see the module docstring); returns its launch counts and
    how many profiler traces were taken again."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.launch import serve
    from repro_torch.models.init import init_block, init_top
    from repro_torch.serve.quantized import PACKED_MLP, PACKED_WEIGHTS
    args = serve.build_parser().parse_args(SERVE_ARGS)
    bits, group = args.wbits, args.group
    cfg = get_config(args.arch)
    dev = "cuda"
    # launch/serve.py::random_packed_lm's draws, in its order
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init_top(cfg, gen, dev)
    x = params["embed"][prompts.to(dev).long()]            # (4, 128, d)
    acts = (x[:, :1], x)                                   # M = 4 and 512
    layers = params["layers"]
    _lib.reset_launches()
    t0 = time.perf_counter()
    n_linear = n_matmul = 0
    for i in range(LAYERS):
        block = init_block(cfg, gen, dev)
        linears = ([(k, block[k], layers[k]) for k in PACKED_WEIGHTS]
                   + [(k, block["mlp"][k], layers["mlp"][k])
                      for k in PACKED_MLP])
        for name, w, served in linears:
            got = ops.quantize_pack(w, bits=bits, group_size=group)
            qt = served[i]
            if not all(torch.equal(a, b) for a, b in
                       zip(got, (qt.packed, qt.scale, qt.zp))):
                raise RuntimeError(f"repack: layer {i} {name} differs from "
                                   f"the served QTensor")
            n_linear += 1
        for name, w, _ in linears:
            if name not in ("wq", "w_up"):
                continue
            amax = torch.amax(w.abs(), dim=0)
            w_scale = amax / torch.full_like(amax, 127.0)
            w_q = torch.clamp(torch.round(w / w_scale), -128, 127).to(
                torch.int8)
            for xa in acts:
                x2 = xa.reshape(-1, xa.shape[-1])
                want = i8.w8a8_dynamic_plain(x2, w_q, w_scale)
                got = ops.w8a8_matmul(xa, w_q, w_scale)
                x_q, x_scale = i8.act_quant_plain(x2, 8)
                got8 = i8.int8_matmul(x_q.to(torch.int8), x_scale, w_q,
                                      w_scale)
                if not (torch.equal(got.reshape(want.shape), want)
                        and torch.equal(got8, want)):
                    raise RuntimeError(f"repack: w8a8 / int8 on layer {i} "
                                       f"{name} at M={x2.shape[0]} differ "
                                       f"from the plain version")
                n_matmul += 1
                probe = (w_q, w_scale)
        del block, linears
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    log(f"[repack] {n_linear} linears of {LAYERS} layers repacked w{bits} "
        f"g{group} by quantize_pack, equal to the served tree (packed, "
        f"scale, zp); {n_matmul} w8a8_matmul + int8_matmul products on the "
        f"prompts' embeddings bit-equal to the plain version; "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    for name in ("quantize_pack", "w8a8_matmul", "int8_matmul"):
        if counts[name] <= 0:
            raise RuntimeError(f"repack: {name} was never launched")
    # device kernels of one call of each entry, after the counts are read
    w_q, w_scale = probe
    retries = 0
    for xa in acts:
        x2 = xa.reshape(-1, xa.shape[-1])
        plain = i8.w8a8_dynamic_plain(x2, w_q, w_scale)
        x_q, x_scale = i8.act_quant_plain(x2, 8)
        x_q = x_q.to(torch.int8)
        for name, fn, want in (
                ("w8a8_matmul", lambda: ops.w8a8_matmul(xa, w_q, w_scale), 2),
                ("int8_matmul",
                 lambda: i8.int8_matmul(x_q, x_scale, w_q, w_scale), 1)):
            names, n = device_kernels(torch, fn, plain)
            retries += n
            ours = [re.search(r"\w+_kernel", k).group(0) for k in names
                    if re.search(r"int8_\w+_kernel|act_quant_kernel", k)]
            log(f"[repack] {name} at M={x_q.shape[0]}: {len(ours)} launch(es) "
                f"a call ({', '.join(ours)}); other device work: "
                f"{len(names) - len(ours)} kernel(s)")
            if len(ours) != want:
                raise RuntimeError(f"repack: {name} launched {len(ours)} "
                                   f"kernels a call, not {want}")
    del x, acts
    torch.cuda.empty_cache()
    return counts, retries


# ---------------------------------------------------------------------------
# 8. calibrate llama-7b-width blocks on the card and serve what they pack
# ---------------------------------------------------------------------------

CALIB_LAYERS = 2          # llama-7b depth cut from 32: calibration's time
CALIB_ARGS = ["--arch", "llama-7b", "--layers", str(CALIB_LAYERS),
              "--method", "affine", "--epochs", "3", "--alpha", "0.1",
              "--calib-samples", "32", "--calib-seq", "512", "--seed", "0",
              "--device", "cuda"]
CALIB_RUNS = {"a": dict(wbits=4, abits=4, group=128, kvbits=8),
              "b": dict(wbits=4, abits=16, group=128, kvbits=16)}
# (b): the packed tree through the kernels against the fake-quant tree
# through the float forward differ only by float reassociation ((h @ inv(A))
# @ Q(A W) against h @ (inv(A) @ Q(A W))) and summation order; on the CPU
# (plain versions, 3 epochs) the largest logit difference was 1.7e-6
# (llama-mini) and 1.4e-6 (d 1024) of the largest logit.
FAKE_TOL = 1e-4


def require_launched(counts: dict, names, tag: str) -> None:
    for name in names:
        if counts[name] <= 0:
            raise RuntimeError(f"{tag}: {name} was never launched")


def _counted_serve(argv: list, params):
    """One serving run through the CLI's entry point, launch counters zeroed
    just before and read just after."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    _lib.reset_launches()
    out = serve.serve(serve.build_parser().parse_args(argv), params)
    return out, dict(_lib.LAUNCHES)


def _margins(torch, out) -> dict:
    """Dominance margin of every full and headwise effective matrix after
    the last epoch (a headwise site: its least margin over the heads)."""
    from repro_torch.core import affine as af
    from repro_torch.core import calibration as cal
    from repro_torch.core import gradual_mask as gm
    ccfg, margins = out["ccfg"], {}
    for i, qp in enumerate(out["info"]["block_qps"]):
        specs = cal._specs_from(qp)
        masks = cal._masks(specs, ccfg.epochs, ccfg, out["model"].device)
        for name, spec in specs.items():
            if spec.kind != "diagonal":
                a = af.effective_matrix(spec, qp["affine"][name], masks[name])
                margins[f"block {i} {name} {spec.kind} "
                        f"{'x'.join(map(str, a.shape))}"] = \
                    float(gm.dominance_margin(a))
    return margins


def calibrate_phase(torch) -> dict:
    """Phase 8 (see the module docstring); returns its launch counts."""
    import tempfile
    import numpy as np
    from repro_torch.launch import calibrate, serve
    from repro_torch.train import checkpoints
    t_phase = time.perf_counter()
    log(f"[calibrate] llama-7b widths, depth cut to {CALIB_LAYERS} of 32 "
        f"layers; 32 x 512 calibration tokens (the paper: 128 x 2048), batch "
        f"8, 3 epochs, alpha 0.1; float32, no TF32")
    counts = {name: 0 for name in KERNELS}
    for run, flags in CALIB_RUNS.items():
        tag = f"calibrate-{run}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = calibrate.calibrate(calibrate.build_parser().parse_args(
            _with(CALIB_ARGS, wbits=flags["wbits"], abits=flags["abits"],
                  group=flags["group"])))
        info, rep = out["info"], out["report"]
        steps = info["step_seconds"]
        kinds = {n: d["kind"] for n, d in info["block_qps"][0]["_sites"].items()}
        log(f"[{tag}] w{flags['wbits']}a{flags['abits']}g{flags['group']} "
            f"sites {kinds}: "
            f"{len(steps)} steps, median {statistics.median(steps):.4f} s a "
            f"step (min {min(steps):.4f}, max {max(steps):.4f}); calibration "
            f"and finalize {time.perf_counter() - t0:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[{tag}] epoch losses per block {info['block_losses']}; held-out "
            f"16 x 512 perplexity fp {rep['fp_ppl']:.4f} -> quant "
            f"{rep['quant_ppl']:.4f} (random weights: informative only)")
        margins = _margins(torch, out)
        log(f"[{tag}] dominance margins (Levy-Desplanques, > 0 = "
            f"invertible): {margins}")
        for i, losses in enumerate(info["block_losses"]):
            if not (len(losses) == out["ccfg"].epochs
                    and all(map(math.isfinite, losses))
                    and losses[-1] < losses[0]):
                raise RuntimeError(f"{tag}: block {i} losses {losses} are not "
                                   f"finite and falling")
        if not (margins and min(margins.values()) > 0):
            raise RuntimeError(f"{tag}: an effective matrix is not strictly "
                               f"diagonally dominant")
        packed, fake, cfg, qcfg = (out[k] for k in ("packed", "fake", "cfg",
                                                   "qcfg"))
        dev = out["model"].device
        del out
        sargv = _with(SERVE_ARGS, layers=CALIB_LAYERS, device=dev.type,
                      **flags)
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            checkpoints.save(ckpt, 0, packed)
            back = checkpoints.load_tree(ckpt, cfg, qcfg, device=dev)
            want, got = checkpoints.flatten(packed), checkpoints.flatten(back)
            same = sorted(want) == sorted(got) and all(
                want[k][1] == got[k][1] and want[k][0].shape == got[k][0].shape
                and want[k][0].tobytes() == got[k][0].tobytes() for k in want)
            log(f"[{tag}] packed tree saved and read back in "
                f"{time.perf_counter() - t0:.1f} s: {len(want)} leaves, "
                f"{sum(a.nbytes for a, _ in want.values())} bytes, "
                f"byte-equal {same}")
            if not same:
                raise RuntimeError(f"{tag}: the checkpoint round trip changed "
                                   f"the packed tree")
            del back, want, got
            mem, c_mem = _counted_serve(sargv, packed)
            disk, c_disk = _counted_serve(sargv + ["--load-packed", ckpt],
                                          None)
        streams = [r.out_tokens for r in mem["requests"]]
        log(f"[{tag}] served {mem['generated']} + {disk['generated']} tokens "
            f"(in memory, --load-packed) at {mem['tokens_per_s']:.2f} / "
            f"{disk['tokens_per_s']:.2f} tok/s; launches {c_mem} / {c_disk}")
        if any(len(s) != 32 for s in streams):
            raise RuntimeError(f"{tag}: a request did not produce 32 tokens")
        if [r.out_tokens for r in disk["requests"]] != streams:
            raise RuntimeError(f"{tag}: --load-packed streams differ from the "
                               f"in-memory tree's")
        log(f"[{tag}] --load-packed greedy streams equal the in-memory tree's")
        main = ("w4a8_matmul",) if flags["abits"] < 16 else ("dequant_matmul",)
        for c in (c_mem, c_disk):
            require_launched(c, main + ("flash_prefill", "flash_decode"), tag)
            for name in KERNELS:
                counts[name] += c[name]
        del disk
        prompts = torch.from_numpy(np.stack(mem["prompts"]))
        gen = torch.tensor(streams, dtype=torch.int32)
        if flags["abits"] < 16:
            gate_blockwise(torch, tag, mem, prompts, gen)
        else:
            a, p = teacher_forced_logits(torch, mem, prompts, gen)
            rel = ((a - p).abs().max() / p.abs().max()).item()
            log(f"[{tag}] teacher-forced logits (prefill + 8 decode steps), "
                f"kernels vs plain: max|dlogit| / max|logit| {rel:.3e} (tol "
                f"{A16_TOL:.0e})")
            if not (torch.isfinite(a).all() and rel <= A16_TOL):
                raise RuntimeError(f"{tag}: kernels and plain versions "
                                   f"disagree")
            del a, p
            lp, ls = serve.packed_and_fake_logits(mem["model"], packed, fake,
                                                 mem["prompts"], streams)
            rel = ((lp - ls).abs().max() / ls.abs().max()).item()
            agree = (lp.argmax(-1) == ls.argmax(-1)).float().mean().item()
            log(f"[{tag}] packed tree (kernels) vs fake-quant tree (float "
                f"forward), teacher-forced over 4 x 32 tokens: max|dlogit| / "
                f"max|logit| {rel:.3e} (tol {FAKE_TOL:.0e}); greedy agreement "
                f"{agree:.4f}")
            if not (torch.isfinite(lp).all() and rel <= FAKE_TOL):
                raise RuntimeError(f"{tag}: the packed tree departs from the "
                                   f"calibrated simulation")
            del lp, ls
        del mem, packed, fake
    torch.cuda.empty_cache()
    log(f"[calibrate] phase wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches {counts}")
    return counts


if __name__ == "__main__":
    main()
