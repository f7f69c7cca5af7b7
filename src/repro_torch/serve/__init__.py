"""Serving of the port: the linear KV cache, the packed model, the engine."""
