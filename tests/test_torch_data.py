"""Port parity: the Markov corpus gives the reference's tokens byte for
byte, and ``make_batch_fn`` the reference's batches."""
import numpy as np
import pytest

from repro.data import MarkovCorpus as JMarkovCorpus
from repro.data import make_batch_fn as jmake_batch_fn
from repro_torch.data import MarkovCorpus, make_batch_fn


@pytest.mark.parametrize("vocab,corpus_seed,seed", [(512, 0, 777),
                                                     (32000, 0, 999),
                                                     (2048, 3, 5)])
def test_sample_byte_equal(vocab, corpus_seed, seed):
    want = JMarkovCorpus(vocab, seed=corpus_seed).sample(6, 40, seed=seed)
    got = MarkovCorpus(vocab, seed=corpus_seed).sample(6, 40, seed=seed)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_batch_fn_matches_reference_and_is_rank_sharded():
    jf = jmake_batch_fn(JMarkovCorpus(256, seed=3), 8, 32, rank=1,
                        num_ranks=4)
    f = make_batch_fn(MarkovCorpus(256, seed=3), 8, 32, rank=1, num_ranks=4)
    assert f(5)["tokens"].tobytes() == jf(5)["tokens"].tobytes()
    assert f(5)["tokens"].shape == (2, 32)
    with pytest.raises(ValueError):
        make_batch_fn(MarkovCorpus(256), 6, 32, num_ranks=4)
