"""The port's gradient codecs and bitmap kernel (plain version) against the JAX package, on the CPU.

``ops/compression.py`` (the threshold and bitmap codecs) against the JAX
package's ``ops/compression.py``, and ``kernels/bitmap_pack.bitmap_encode``
against both the JAX codec and the JAX Pallas kernel
(``kernels/bitmap_pack.bitmap_encode(backend="pallas")``, interpret mode
off a TPU). The codecs are exact: packed words, indices, signs, counts
and float32 residuals are compared bit for bit. The CUDA kernel itself is
held against these plain versions on the card (test_torch_bitmap_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import bitmap_pack as jax_bitmap
from deeplearning4j_tpu.ops import compression as jax_codec
from deeplearning4j_tpu_torch.kernels import bitmap_pack
from deeplearning4j_tpu_torch.ops import compression

THR = 0.7  # leaves all three codes populated in N(0, 1) data


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _grad(shape, seed, dtype=np.float32):
    g = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    flat = g.reshape(-1)
    if flat.size >= 16:
        flat[15] = -2.0  # code 2 in slot 15: bit 31, a negative word
    return g


def _bits(a):
    """A float array's bit pattern, so that -0.0 and NaN compare exactly."""
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.view(np.int16)


@pytest.fixture(scope="module")
def jax_encoders():
    return {
        "xla": jax.jit(jax_codec.bitmap_encode, static_argnums=1),
        "pallas": jax.jit(lambda g, t: jax_bitmap.bitmap_encode(
            g, t, backend="pallas"), static_argnums=1),
    }


@pytest.mark.parametrize("shape", [(1,), (15,), (16,), (2049,), (5000,),
                                   (37, 45)], ids=str)
def test_bitmap_encode_is_bit_identical_to_both_jax_paths(shape,
                                                          jax_encoders):
    g = _grad(shape, seed=shape[0])
    tg = torch.from_numpy(g)
    port = {"codec": compression.bitmap_encode(tg, THR),
            "kernel_plain": bitmap_pack.bitmap_encode(tg, THR),
            "xla_backend": bitmap_pack.bitmap_encode(tg, THR,
                                                     backend="xla")}
    n_words = (g.size + 15) // 16
    for jname, enc in jax_encoders.items():
        jpacked, jresid = (np.asarray(a) for a in enc(g, THR))
        assert jpacked.dtype == np.int32 and jpacked.shape == (n_words,)
        for name, (packed, resid) in port.items():
            assert packed.dtype == torch.int32, name
            np.testing.assert_array_equal(packed.numpy(), jpacked,
                                          err_msg=f"{name} vs {jname}")
            assert resid.shape == g.shape
            np.testing.assert_array_equal(_bits(resid), _bits(jresid),
                                          err_msg=f"{name} vs {jname}")
    if g.size >= 16:
        assert int(port["codec"][0][0]) < 0  # the sign bit is set
    codes = set()
    for w in port["codec"][0].numpy().astype(np.int64) & 0xFFFFFFFF:
        codes |= {(int(w) >> (2 * i)) & 3 for i in range(16)}
    if g.size >= 16:
        assert codes == {0, 1, 2}


def test_bf16_kernel_rule_matches_the_jax_pallas_kernel(jax_encoders):
    """bfloat16: the kernel's plain version compares and subtracts in
    float32 and rounds the residual once, as the Pallas kernel does; bit
    for bit against it. (The codec compares in bfloat16, as the JAX
    package's XLA codec does.)"""
    g = _grad((4100,), seed=3).astype(jnp.bfloat16)
    jpacked, jresid = (np.asarray(a) for a in jax_encoders["pallas"](g, THR))
    tg = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
    packed, resid = bitmap_pack.bitmap_encode(tg, THR)
    assert resid.dtype == torch.bfloat16
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(resid.view(torch.int16).numpy(),
                                  jresid.view(np.int16))


def test_bitmap_decode_matches_jax_and_restores_the_gradient():
    g = _grad((3, 1000), seed=8)
    packed, resid = compression.bitmap_encode(torch.from_numpy(g), THR)
    got = compression.bitmap_decode(packed, THR, g.shape)
    want = np.asarray(jax_codec.bitmap_decode(jnp.asarray(packed.numpy()),
                                              THR, g.shape))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # decode + residual is g to 1 ulp (g = sent + (g - sent), rounded)
    np.testing.assert_allclose((got + resid).numpy(), g, rtol=2 ** -23,
                               atol=0)


@pytest.mark.parametrize("case", ["ties", "overflow", "underfull"])
def test_threshold_codec_matches_jax(case):
    """Slots go to the largest magnitudes, the lower index first among
    equal ones (ties); entries past ``max_elements`` stay in the residual
    (overflow); unused slots are -1 / 0 (underfull)."""
    r = np.random.default_rng(21)
    g = r.standard_normal(257).astype(np.float32)
    if case == "ties":
        g = 0.1 * g  # under the threshold but for the entries set here
        g[[3, 50, 7, 200]] = [1.5, -1.5, 1.5, -1.5]
        g[[9, 90]] = [3.0, -3.0]
        max_el = 4
    elif case == "overflow":
        max_el = 20
    else:
        g = 0.1 * g
        g[[4, 44]] = [0.9, -2.0]
        max_el = 30
    jenc, jres = jax_codec.threshold_encode(jnp.asarray(g), THR, max_el)
    enc, res = compression.threshold_encode(torch.from_numpy(g), THR,
                                            max_el)
    np.testing.assert_array_equal(enc.indices.numpy(), np.asarray(
        jenc.indices))
    np.testing.assert_array_equal(enc.signs.numpy(), np.asarray(jenc.signs))
    assert enc.indices.dtype == torch.int32 and enc.signs.dtype == torch.int8
    assert int(enc.count) == int(jenc.count)
    assert float(enc.threshold) == float(jenc.threshold)
    np.testing.assert_array_equal(_bits(res), _bits(jres))
    if case == "ties":
        assert enc.indices.tolist() == [9, 90, 3, 7]
    if case == "overflow":
        assert int(enc.count) == max_el < int((np.abs(g) >= THR).sum())
    if case == "underfull":
        assert int(enc.count) == 2 and enc.indices.tolist()[2:] == [-1] * 28
    dec = compression.threshold_decode(enc, g.shape)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jax_codec.threshold_decode(jenc, g.shape)))
    assert compression.compress_ratio(g.size, enc) == pytest.approx(
        jax_codec.compress_ratio(g.size, jenc))


def test_threshold_codec_on_a_short_gradient_pads_the_slots():
    """max_elements above n: k = n live candidates, the rest padding."""
    g = np.array([0.8, -0.1, -0.75], np.float32)
    jenc, jres = jax_codec.threshold_encode(jnp.asarray(g), THR, 5)
    enc, res = compression.threshold_encode(torch.from_numpy(g), THR, 5)
    assert enc.indices.tolist() == np.asarray(jenc.indices).tolist() == [
        0, 2, -1, -1, -1]
    np.testing.assert_array_equal(enc.signs.numpy(), np.asarray(jenc.signs))
    np.testing.assert_array_equal(_bits(res), _bits(jres))


def test_unknown_backend_and_cpu_wrapper_are_refused():
    g = torch.zeros(4)
    with pytest.raises(ValueError, match="backend"):
        bitmap_pack.bitmap_encode(g, THR, backend="triton")
    with pytest.raises(ValueError, match="CUDA"):
        bitmap_pack.bitmap_encode_cuda(g, THR)
