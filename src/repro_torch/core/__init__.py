"""Quantization core of the port: packing, QTensor, the RTN quantizer."""
