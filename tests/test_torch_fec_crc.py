"""The port's CRC-24Q (utils/crc.py) and K=7 rate-1/2 coder and Viterbi
decoders (utils/fec.py) vs the JAX package's, on seeded bits and soft
symbols.

Every output is bits or integers, so each case is exact: the same CRC, the
same symbols, the same decoded bits (the decoders' add-compare-select
tie-breaks included, which hard 0/1 symbols with flips exercise).
"""
import numpy as np
import pytest

from gps_jamming_tpu.utils import crc as jcrc
from gps_jamming_tpu.utils import fec as jfec
from gps_jamming_tpu_torch.utils import crc as tcrc
from gps_jamming_tpu_torch.utils import fec as tfec


@pytest.mark.parametrize("n_bits", [1, 24, 196, 226, 1000])
def test_crc24q_bits_matches_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    for _ in range(5):
        bits = rng.integers(0, 2, n_bits)
        assert tcrc.crc24q_bits(bits) == jcrc.crc24q_bits(bits)
    assert tcrc.crc24q_bits(np.zeros(n_bits, np.int64)) == 0


@pytest.mark.parametrize("n_bytes", [0, 1, 3, 29, 250])
def test_crc24q_bytes_matches_jax(n_bytes):
    rng = np.random.default_rng(100 + n_bytes)
    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    want = jcrc.crc24q(data)
    assert tcrc.crc24q(data) == want
    assert tcrc.crc24q(data.tobytes()) == want
    assert tcrc.check_crc24q(data.tobytes(), want) \
        == jcrc.check_crc24q(data.tobytes(), want) is True
    assert tcrc.check_crc24q(data.tobytes(), want ^ 1) is False
    # the byte form and the bit form agree on whole bytes
    assert tcrc.crc24q_bits(np.unpackbits(data)) == want


def test_crc24q_tables_equal():
    np.testing.assert_array_equal(tcrc._TABLE, jcrc._TABLE)


@pytest.mark.parametrize("invert_g2", [True, False])
@pytest.mark.parametrize("terminate", [True, False])
def test_encode_matches_jax(invert_g2, terminate):
    rng = np.random.default_rng(7 + 2 * invert_g2 + terminate)
    bits = rng.integers(0, 2, 114)
    got = tfec.encode(bits, invert_g2=invert_g2, terminate=terminate)
    want = jfec.encode(bits, invert_g2=invert_g2, terminate=terminate)
    np.testing.assert_array_equal(got, want)
    assert got.size == 2 * (114 + 6 * terminate)
    for name in ("_OUT1", "_OUT2", "_NEXT"):
        np.testing.assert_array_equal(getattr(tfec, name),
                                      getattr(jfec, name))


def _soft(rng, sym, noise, n_flip):
    """Soft '1' probabilities: symbols + gaussian noise, clipped, with
    n_flip hard-flipped symbols."""
    s = np.clip(sym + noise * rng.standard_normal(sym.size), 0.0, 1.0)
    flip = rng.choice(sym.size, n_flip, replace=False)
    s[flip] = 1.0 - np.round(s[flip])
    return s


@pytest.mark.parametrize("invert_g2,terminated", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("noise,n_flip", [(0.0, 0), (0.0, 6), (0.25, 4),
                                          (0.45, 10)])
def test_viterbi_decode_matches_jax(invert_g2, terminated, noise, n_flip):
    rng = np.random.default_rng(int(100 * noise) + n_flip + invert_g2)
    bits = rng.integers(0, 2, 200)
    sym = tfec.encode(bits, invert_g2=invert_g2,
                      terminate=terminated).astype(np.float64)
    soft = _soft(rng, sym, noise, n_flip)
    got = tfec.viterbi_decode(soft, invert_g2=invert_g2,
                              terminated=terminated)
    want = jfec.viterbi_decode(soft, invert_g2=invert_g2,
                               terminated=terminated)
    np.testing.assert_array_equal(got, want)
    if noise == 0.0 and n_flip == 0:
        np.testing.assert_array_equal(got[:200], bits)


@pytest.mark.parametrize("invert_g2,terminated", [(True, True),
                                                  (False, False),
                                                  (True, False)])
def test_viterbi_decode_batch_matches_jax(invert_g2, terminated):
    rng = np.random.default_rng(31 + invert_g2 + 2 * terminated)
    rows = []
    for r in range(9):
        sym = tfec.encode(rng.integers(0, 2, 114), invert_g2=invert_g2,
                          terminate=terminated).astype(np.float64)
        rows.append(_soft(rng, sym, 0.1 * (r % 5), r))
    rows = np.stack(rows)
    got = tfec.viterbi_decode_batch(rows, invert_g2=invert_g2,
                                    terminated=terminated)
    want = jfec.viterbi_decode_batch(rows, invert_g2=invert_g2,
                                     terminated=terminated)
    np.testing.assert_array_equal(got, want)
    # the batch equals the rows decoded one at a time
    for r in range(rows.shape[0]):
        np.testing.assert_array_equal(
            got[r], tfec.viterbi_decode(rows[r], invert_g2=invert_g2,
                                        terminated=terminated))
