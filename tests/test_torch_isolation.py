"""The port stands alone: importing ``repro_torch`` (every module) and
``chip_smoke`` loads neither jax nor anything of the reference package, and
a CUDA request without CUDA raises instead of running on the CPU."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.dequant_matmul import dequant_matmul
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_paged)
from repro_torch.kernels.int8_matmul import (int8_matmul, w4a8_matmul,
                                             w8a8_matmul)
from repro_torch.kernels.quantize_pack import quantize_pack

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.startswith("jax")))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: dequant_matmul(_meta(2, 64), _meta(32, 16, dtype=torch.uint8),
                           _meta(2, 16), _meta(2, 16), bits=4,
                           group_size=32),
    lambda: w4a8_matmul(_meta(2, 64), _meta(32, 16, dtype=torch.uint8),
                        _meta(2, 16), _meta(2, 16), bits=4, group_size=32,
                        a_bits=4),
    lambda: flash_decode(_meta(1, 2, 1, 32), _meta(1, 16, 2, 32),
                         _meta(1, 16, 2, 32), _meta(1, dtype=torch.int32)),
    lambda: flash_prefill(_meta(1, 2, 4, 1, 32), _meta(1, 16, 2, 32),
                          _meta(1, 16, 2, 32), _meta(1, dtype=torch.int32),
                          _meta(1, dtype=torch.int32)),
    lambda: flash_decode_paged(_meta(1, 2, 1, 32), _meta(3, 8, 2, 32),
                               _meta(3, 8, 2, 32), _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32)),
    lambda: flash_prefill_paged(_meta(1, 2, 4, 1, 32), _meta(3, 8, 2, 32),
                                _meta(3, 8, 2, 32),
                                _meta(1, 2, dtype=torch.int32),
                                _meta(1, dtype=torch.int32),
                                _meta(1, dtype=torch.int32)),
    lambda: int8_matmul(_meta(2, 64, dtype=torch.int8), _meta(2, 1),
                        _meta(64, 16, dtype=torch.int8), _meta(16)),
    lambda: w8a8_matmul(_meta(2, 64), _meta(64, 16, dtype=torch.int8),
                        _meta(16)),
    lambda: quantize_pack(_meta(64, 16), bits=4, group_size=32),
], ids=["dequant_matmul", "w4a8_matmul", "flash_decode", "flash_prefill",
        "flash_decode_paged", "flash_prefill_paged", "int8_matmul",
        "w8a8_matmul", "quantize_pack"])
def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch(call):
    """A wrapper runs its plain version only for CPU tensors."""
    with pytest.raises(ValueError, match="no kernel for device"):
        call()


def test_cuda_requests_without_cuda_raise(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch import serve
    from repro_torch.serve.quantized import QuantizedModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_lib, "_LIB", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _lib.lib()
    # the launch every kernel wrapper makes for CUDA tensors
    for kernel in ("int8_matmul", "w8a8_matmul", "quantize_pack"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _lib.launch(kernel)
    with pytest.raises(RuntimeError, match="cuda"):
        QuantizedModel(get_config("llama-micro"), QuantConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama-micro"])
    from repro_torch.launch.mesh import make_serving_mesh
    with pytest.raises(RuntimeError, match="cuda"):
        make_serving_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama-micro", "--mesh-model", "2"])
