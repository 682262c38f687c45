"""Port spreading codes, resamplers and replica tables (ops.codes,
models.receiver.galileo, models.receiver.glonass,
acquisition.sbas_replica_table_host) vs the JAX package.

Codes and replica planes are bit-equal (the same NumPy arithmetic);
`resample_code` is equal (float32 phase, floor index, in the same order);
`resample_code_bandlimited` agrees within 1e-5 absolute (float32 FFTs of
different libraries on a +/-1 waveform).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.models.receiver import galileo as jgal
from gps_jamming_tpu.models.receiver import glonass as jglo
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.models.receiver import galileo as tgal
from gps_jamming_tpu_torch.models.receiver import glonass as tglo
from gps_jamming_tpu_torch.ops import codes as tcodes

torch.set_num_threads(2)


def test_sbas_and_glonass_codes_equal_jax():
    for prn in range(120, 139):
        np.testing.assert_array_equal(tcodes.sbas_ca_code(prn),
                                      jcodes.sbas_ca_code(prn))
    np.testing.assert_array_equal(tcodes.sbas_ca_table(),
                                  jcodes.sbas_ca_table())
    with pytest.raises(ValueError):
        tcodes.sbas_ca_code(119)
    np.testing.assert_array_equal(tcodes.glonass_code(),
                                  jcodes.glonass_code())
    code = jcodes.gps_ca_code(5)
    np.testing.assert_array_equal(tcodes.boc11(code), jcodes.boc11(code))


def test_e1b_codes_equal_jax_and_the_icd():
    """PRN 1-50 from the JAX package's npz, read by path; PRN 1 starts
    with the ICD's hex F5D71013 (logical 0 -> +1), as
    tests/test_galileo.py pins it."""
    for prn in range(1, 51):
        np.testing.assert_array_equal(tgal.e1b_code(prn), jgal.e1b_code(prn))
    prefix_hex = 0xF5D71013
    bits = [(prefix_hex >> (31 - i)) & 1 for i in range(32)]
    np.testing.assert_array_equal(tgal.e1b_code(1)[:32],
                                  np.array([1 - 2 * b for b in bits]))
    for prn in (1, 7, 36):
        np.testing.assert_array_equal(tgal.synthetic_e1b_code(prn),
                                      jgal.synthetic_e1b_code(prn))
        np.testing.assert_array_equal(tgal.e1b_boc_code(prn),
                                      jgal.e1b_boc_code(prn))
    assert (tgal.CODE_LEN, tgal.BOC_LEN, tgal.BOC_RATE, tgal.PERIOD_S) == \
        (jgal.CODE_LEN, jgal.BOC_LEN, jgal.BOC_RATE, jgal.PERIOD_S)


def test_load_icd_codes_overrides_the_table(tmp_path, monkeypatch):
    monkeypatch.setattr(tgal, "_ICD_CODES", {})
    path = tmp_path / "e1b.hex"
    path.write_text("3 " + "A" * 1023 + "\nnot a code line\n")
    assert tgal.load_icd_codes(str(path)) == 1
    np.testing.assert_array_equal(tgal.e1b_code(3)[:4], [-1, 1, -1, 1])
    np.testing.assert_array_equal(tgal.e1b_code(4), jgal.e1b_code(4))


@pytest.mark.parametrize("system", ["galileo", "sbas", "glonass"])
def test_replica_planes_equal_jax(system):
    if system == "galileo":
        got = tgal.replica_table_host(4.096e6, 16384)
        want = jgal.replica_table_host(4.096e6, 16384)
        assert got[0].shape == (36, 16384)
    elif system == "sbas":
        got = tacq.sbas_replica_table_host(2.048e6, 2048)
        want = jacq.sbas_replica_table_host(2.048e6, 2048)
        assert got[0].shape == (19, 2048)
    else:
        got = tglo.replica_table_host(10e6, 10000)
        want = jglo.replica_table_host(10e6, 10000)
        np.testing.assert_array_equal(tglo.channel_offsets_hz(),
                                      jglo.channel_offsets_hz())
    np.testing.assert_array_equal(got[0], want.re)
    np.testing.assert_array_equal(got[1], want.im)


@pytest.mark.parametrize("f,fs,n,rem,shift", [
    (1.023e6, 2.048e6, 2048, 0.0, 0.0),
    (1.023e6 * (1 + 3000.0 / 1575.42e6), 2.048e6, 65536, 0.0, 0.0),
    (2.046e6, 16.384e6, 65536, 1000.5, 0.25),
    (0.511e6, 10e6, 10000, -3.75, 0.0),
])
def test_resample_code_equals_jax(f, fs, n, rem, shift):
    table = jcodes.gps_ca_table()[:3]
    want = np.asarray(jcodes.resample_code(jnp.asarray(table), f, fs, n,
                                           rem, shift))
    got = tcodes.resample_code(torch.from_numpy(table), f, fs, n, rem, shift)
    np.testing.assert_array_equal(got.numpy(), want)


def test_resample_code_per_row_rates_equal_jax():
    """One rate per row as a float32 tensor, as refine_doppler resamples
    (the JAX package vmaps over rows)."""
    table = jcodes.gps_ca_table()[:4]
    fcode = (1.023e6 * (1.0 + np.array([-7000.0, -150.0, 200.0, 6800.0])
                        / 1575.42e6)).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda c, f: jcodes.resample_code(c, f, 2.048e6, 65536))(
            jnp.asarray(table), jnp.asarray(fcode)))
    got = tcodes.resample_code(torch.from_numpy(table),
                               torch.from_numpy(fcode), 2.048e6, 65536)
    np.testing.assert_array_equal(got.numpy(), want)


def test_resample_code_bandlimited_matches_jax():
    code = jgal.e1b_boc_code(4).astype(np.float32)
    f = jgal.BOC_RATE * (1.0 + 900.0 / 1575.42e6)
    want = np.asarray(jcodes.resample_code_bandlimited(
        jnp.asarray(code), f, 4.096e6, 32768, rem_chips=1000.5))
    got = tcodes.resample_code_bandlimited(torch.from_numpy(code), f,
                                           4.096e6, 32768, rem_chips=1000.5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
