"""PyTorch + CUDA port of AffineQuant: calibration and packed serving.

A second package beside the JAX reference (``src/repro``).  It serves a
llama-family model from packed w{2,4,8} ``QTensor`` weights with per-token
dynamic a4/a8 activations and a kv4, kv8 or fp KV cache, linear or paged,
through six CUDA C++ kernels written for Hopper (``csrc/``):

    w4a8_matmul          every linear at a_bits < 16
    dequant_matmul       every linear at a16
    flash_decode         one-token attention over the linear cache as stored
    flash_prefill        chunked causal attention over the linear cache
    flash_decode_paged   flash_decode over page pools and a page table
    flash_prefill_paged  flash_prefill over page pools and a page table

It also calibrates: block-wise AffineQuant (affine transforms under the
gradual mask, learnable weight clipping, merging, packed finalize) over the
float dense llama model, with npz checkpoints in the reference's layout
(``launch/calibrate.py``; ``launch/serve.py --calibrate / --load-packed``).
Calibration runs on PyTorch's own products, solves and autograd, as the
reference runs it on plain ``jnp``.

Entry points default to ``device="cuda"``; the CPU runs only when the caller
asks for it, and then every kernel wrapper runs its plain PyTorch version.
The package imports ``torch`` and ``numpy`` only.
"""
