"""PyTorch + CUDA port of the packed quantized serving path.

A second package beside the JAX reference (``src/repro``).  It serves a
llama-family model from packed w{2,4,8} ``QTensor`` weights with per-token
dynamic a4/a8 activations and an int8 (kv8) or fp (kv16) linear KV cache,
through four CUDA C++ kernels written for Hopper (``csrc/``):

    w4a8_matmul     every linear at a_bits < 16
    dequant_matmul  every linear at a16
    flash_decode    one-token attention over the cache as stored
    flash_prefill   chunked causal attention over the cache as stored

Entry points default to ``device="cuda"``; the CPU runs only when the caller
asks for it, and then every kernel wrapper runs its plain PyTorch version.
The package imports ``torch`` and ``numpy`` only.
"""
