"""Calibration and evaluation data of the port: the synthetic Markov corpus."""
from repro_torch.data.pipeline import MarkovCorpus, make_batch_fn

__all__ = ["MarkovCorpus", "make_batch_fn"]
