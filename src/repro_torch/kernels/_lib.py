"""Build, load and count the CUDA kernels of ``repro_torch/csrc``.

The sources have a plain C interface: each is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into one
shared library and loaded with ``ctypes``.  The build happens at first use,
into ``repro_torch/build/<hash of sources and flags>/``, so a checkout that
holds only the sources builds everything it needs.  Nothing here runs at
import time: the CPU-only test lane imports every module.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it, and
``dequant_matmul``'s again by the body that ran (``dequant_matmul/<body>``).
It and the library handle are the package's only global state.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("dequant_matmul.cu", "w4a8_matmul.cu", "flash_decode.cu",
           "flash_prefill.cu", "int8_matmul.cu", "quantize_pack.cu")
HEADERS = ("common.cuh", "flash_common.cuh")
# IEEE division and rounding are part of the kernels' contract with their
# plain versions: no --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"dequant_matmul": 0, "w4a8_matmul": 0, "flash_decode": 0,
            "flash_prefill": 0, "flash_decode_paged": 0,
            "flash_prefill_paged": 0, "int8_matmul": 0, "w8a8_matmul": 0,
            "quantize_pack": 0,
            # dequant_matmul's launches again, by the body that ran
            "dequant_matmul/decode": 0, "dequant_matmul/tile": 0,
            "dequant_matmul/tile_split": 0}
BUILD_INFO: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, packed, scale, zp, out, workspace, M, K, N, bits, group, stream
    "aq_dequant_matmul": [_P] * 6 + [_I] * 5 + [_P],
    # M, K, N -> the bytes of aq_dequant_matmul's workspace
    "aq_dequant_workspace_bytes": [_I] * 3,
    # M, K, N -> body | BM << 8 | BN << 16 | K chunks << 24
    "aq_dequant_plan": [_I] * 3,
    # x, workspace, workspace bytes, packed, scale, zp, out, M, K, N, bits,
    # group, a_bits, stream
    "aq_w4a8_matmul": [_P, _P, _L] + [_P] * 4 + [_I] * 6 + [_P],
    # M, K, N, group -> the bytes of aq_w4a8_matmul's workspace
    "aq_w4a8_workspace_bytes": [_I] * 4,
    # The flash entries take the cache format as kv_bits: 16, 8 or 4.
    # q, k, v, k_scale, v_scale, cur_len, out, B, S, Hkv, G, D, scale,
    # kv_bits, stream
    "aq_flash_decode": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, page_table, cur_len, out, B, page,
    # max_pages, Hkv, G, D, scale, kv_bits, stream
    "aq_flash_decode_paged": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, offset, chunk_len, out, B, S, Hkv, C, G, D,
    # scale, kv_bits, stream
    "aq_flash_prefill": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, page_table, offset, chunk_len, out, B,
    # page, max_pages, Hkv, C, G, D, scale, kv_bits, stream
    "aq_flash_prefill_paged": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    # x_q, x_scale, w_q, w_scale, out, M, K, N, stream
    "aq_int8_matmul": [_P] * 5 + [_I] * 3 + [_P],
    # x, workspace, workspace bytes, w_q, w_scale, out, M, K, N, stream
    "aq_w8a8_matmul": [_P, _P, _L] + [_P] * 3 + [_I] * 3 + [_P],
    # M, K -> the bytes of aq_w8a8_matmul's workspace
    "aq_w8a8_workspace_bytes": [_I] * 2,
    # M, K, N, x_q, w_q -> the body int8_matmul runs (0 decode, 1 wgmma,
    # 2 mma_sync)
    "aq_int8_body": [_I] * 3 + [_P] * 2,
    # w, packed, scale, zp, B, K, N, bits, group, stream
    "aq_quantize_pack": [_P] * 4 + [_I] * 5 + [_P],
}
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library; a
    build of the same sources and flags is reused.  Returns its path."""
    nvcc = _nvcc()
    out_dir = BUILD / _source_hash(nvcc)
    so = out_dir / "libaq_kernels.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD))
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    (tmp / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / so.name)]
        + [str(tmp / (Path(n).stem + ".o")) for n in SOURCES],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    try:
        tmp.rename(out_dir)
    except OSError:          # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0,
                      cached=False, log=str(out_dir / "build.log"))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use).  Raises without a
    CUDA device: the kernels have no CPU form."""
    global _LIB
    if _LIB is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device; CPU "
                               "tensors run the plain versions")
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = (_L if name.endswith(("_bytes", "_plan"))
                          else ctypes.c_int)
        _LIB = handle
    return _LIB


def launch(kernel: str, *args) -> None:
    """Call C entry ``aq_<kernel>`` on the current stream, raise on a
    launch error, and count the launch."""
    fn = getattr(lib(), "aq_" + kernel)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    LAUNCHES[kernel] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device and contiguity checks shared by every wrapper."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
