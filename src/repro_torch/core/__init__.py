"""Quantization core of the port: packing, QTensor, the quantizer with
learnable clipping, affine transforms, the gradual mask, merges and
block-wise calibration."""
