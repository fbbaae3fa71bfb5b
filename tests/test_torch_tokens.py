"""The port's token pipeline (``data/tokens.py``) against the JAX
package's: numpy on both sides, so batches are bit-identical, and a restart
from ``state_dict`` continues identically — within the port and across the
two packages."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import tokens as jtok  # noqa: E402
from repro_torch.data import tokens as ttok  # noqa: E402


def _same(a, b):
    for f in ("tokens", "targets", "mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.num_tokens == b.num_tokens


@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (3, 1, 2),
                                             (7, 2, 4)])
def test_batches_are_bit_identical(seed, host, hosts):
    kw = dict(vocab_size=512, seq_len=16, batch_size=4, seed=seed,
              host_id=host, num_hosts=hosts)
    j, t = jtok.TokenPipeline(**kw), ttok.TokenPipeline(**kw)
    for _ in range(4):
        _same(next(j), next(t))


def test_synthetic_token_batches_are_bit_identical():
    want = jtok.synthetic_token_batches(300, 8, 3, 5, seed=2)
    got = ttok.synthetic_token_batches(300, 8, 3, 5, seed=2)
    assert len(got) == 5
    for a, b in zip(got, want):
        _same(a, b)
        assert b.tokens.max() < 300 and b.tokens.min() >= 0
        np.testing.assert_array_equal(a.targets[:, :-1], a.tokens[:, 1:])


def test_restart_from_state_dict_continues_identically():
    p1 = ttok.TokenPipeline(vocab_size=512, seq_len=16, batch_size=4, seed=3)
    [next(p1) for _ in range(3)]
    state = p1.state_dict()
    nxt = next(p1)
    p2 = ttok.TokenPipeline(vocab_size=512, seq_len=16, batch_size=4, seed=3)
    p2.load_state_dict(state)
    _same(next(p2), nxt)
    # The port's state restores into the reference's pipeline too.
    j = jtok.TokenPipeline(vocab_size=512, seq_len=16, batch_size=4, seed=3)
    j.load_state_dict(state)
    _same(next(j), nxt)
    assert p2.state_dict()["step"] == 4


def test_host_id_is_validated():
    with pytest.raises(ValueError, match="host_id"):
        ttok.TokenPipeline(vocab_size=8, seq_len=2, batch_size=1,
                           host_id=2, num_hosts=2)
