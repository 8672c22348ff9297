"""The port's threefry stream (tpusplat_torch/train/prng.py) against
``jax.random`` on the same keys, on the CPU: keys, bits, uniforms and
normals bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpusplat_torch.train import prng

torch.set_num_threads(2)

LO = np.nextafter(np.float32(-1), np.float32(0))


def _data(k):
    return tuple(int(v) for v in jax.random.key_data(k))


def _jax_key(k):
    return jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32))


def test_keys_match_jax():
    """key(0), key(7), a chain of three splits with fold_in(., 1) of each
    new key, and a three-way split."""
    assert prng.key(0) == _data(jax.random.key(0)) == (0, 0)
    assert prng.key(7) == _data(jax.random.key(7))
    jk, tk = jax.random.key(0), prng.key(0)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert (tk, tsub) == (_data(jk), _data(jsub))
        assert prng.fold_in(tsub, 1) == _data(jax.random.fold_in(jsub, 1))
    assert prng.split(prng.key(7), 3) == [_data(k) for k in jax.random.split(jax.random.key(7), 3)]


@pytest.mark.parametrize("shape", [(1,), (5, 3), (1001, 3), (70_001, 3)])
def test_bits_uniform_and_normal_match_jax(shape):
    """The draws of apps/train.py's first densify key, bit for bit."""
    k = prng.split(prng.key(0))[1]
    jk = _jax_key(k)
    bits = prng.random_bits(k, shape, "cpu")
    assert bits.shape == shape and bits.dtype == torch.int64
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform_pm1(bits).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape, jnp.float32, LO, 1.0)))
    got = prng.normal(k, shape, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.normal(jk, shape)))


def test_a_key_tensor_draws_as_the_same_key_held_as_ints():
    """fold_in, random_bits and normal of a key tensor (the form a compiled
    densify round takes) equal those of the same key as a pair of ints, bit
    for bit, and jax.random's."""
    k = prng.split(prng.split(prng.key(0))[0])[1]
    kt = prng.key_tensor(k, "cpu")
    assert kt.dtype == torch.int64 and kt.shape == (2,)
    folded = prng.fold_in(kt, 1)
    assert isinstance(folded, torch.Tensor) and tuple(folded.tolist()) == prng.fold_in(k, 1)
    for a, b in ((k, kt), (prng.fold_in(k, 1), folded)):
        np.testing.assert_array_equal(prng.random_bits(b, (1001, 3), "cpu").numpy(),
                                      prng.random_bits(a, (1001, 3), "cpu").numpy())
        got = prng.normal(b, (1001, 3), "cpu").numpy()
        np.testing.assert_array_equal(got, prng.normal(a, (1001, 3), "cpu").numpy())
        want = np.asarray(jax.random.normal(_jax_key(a), (1001, 3)))
        np.testing.assert_array_equal(got, want)


def test_normal_over_every_uniform_matches_jax():
    """All 2**23 uniforms the normal can draw (it reads only bits >> 9)
    against ``sqrt(2) * lax.erf_inv`` on the same u: 0 of 8,388,608 values
    differ. The reference is XLA:CPU's x86 code for the normal, whose
    multiply-adds are FMA instructions."""
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9
    u = prng.uniform_pm1(bits)
    u_ref = np.maximum(LO, ((np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000))
                            .view(np.float32) - np.float32(1)) * np.float32(2) + LO)
    np.testing.assert_array_equal(u.numpy(), u_ref)
    want = np.asarray(jax.jit(lambda x: jnp.sqrt(jnp.float32(2)) * lax.erf_inv(x))(u.numpy()))
    got = prng.normal_from_bits(bits).numpy()
    assert np.isfinite(got).all()
    differ = got != want
    assert not differ.any(), (int(differ.sum()), got[differ][:5], want[differ][:5])
