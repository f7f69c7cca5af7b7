"""Kernels of the serving path: each module holds a CUDA kernel's wrapper
and its plain PyTorch version; :mod:`repro_torch.kernels.ops` dispatches."""
