"""popsift_torch.wirecodec against popsift_tpu.wirecodec, both on the CPU.

The port's encoder must give the JAX package's numpy encoder
(``_encode_u8_numpy``) byte for byte, and its decoder the JAX ``decode_u8``
bit for bit, on images that reach each scheme (bits 1, 2 and 4), on a
noise image (no buffer from either) and on one 1080p scene.  Buffers with
one byte flipped after the header pin the clamping semantics: the two
decoders must then agree with each other, not with the image.  The JAX
package's native encoder is never used here.
"""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from popsift_tpu import wirecodec as jwc  # noqa: E402

import popsift_torch as pt  # noqa: E402
from popsift_torch import wirecodec as twc  # noqa: E402
from popsift_torch.extract import extract_features  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _smooth(seed, h, w, passes=4):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    for _ in range(passes):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5
    return (img * 255).astype(np.uint8)


def _integrate(d2):
    """The image whose mod-256 second difference is ``d2``."""
    dy = np.cumsum(d2 % 256, axis=1) % 256
    return (np.cumsum(dy, axis=0) % 256).astype(np.uint8)


def _bitmap_image():
    """~15% +-1 residuals, ~1% escapes: the bitmap scheme (bits=1)."""
    rng = np.random.default_rng(5)
    m = rng.random((192, 320))
    d2 = np.zeros(m.shape, np.int16)
    d2[m < 0.075] = 1
    d2[(m >= 0.075) & (m < 0.15)] = -1
    d2[m > 0.99] = rng.integers(-100, 100)
    return _integrate(d2)


def _two_bit_image():
    """Every residual +-1, a few escapes: the 2-bit codes (bits=2)."""
    rng = np.random.default_rng(11)
    d2 = rng.choice(np.array([-1, 1], np.int16), (160, 224))
    d2[rng.random(d2.shape) > 0.995] = 77
    return _integrate(d2)


def _four_bit_image():
    """Residuals in [-5, 5] and a few beyond: the nibbles (bits=4)."""
    rng = np.random.default_rng(3)
    d2 = rng.integers(-5, 6, (128, 256)).astype(np.int16)
    d2[rng.random(d2.shape) > 0.99] = -90
    return _integrate(d2)


def _make_scene(seed, h, w):
    """chip_smoke.make_scene: the repository's benchmark scenes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_scene(seed, h, w)


def _images():
    """tests/test_wirecodec.py's images, then one a scheme, and noise."""
    smooth = _smooth(7, 240, 384)
    row = [0]
    for step in range(1, 129):
        row += [(row[-1] + step) % 256, (row[-1]) % 256]
    return [
        ("smooth", smooth),
        ("flat", np.full((96, 128), 200, np.uint8)),
        ("ramp", (np.arange(200)[None, :] * np.ones((81, 1))
                  % 256).astype(np.uint8)),
        ("odd", smooth[:233, :131]),
        ("tiny", smooth[:8, :16]),
        ("extremes", np.tile(np.array([[0, 255]], np.uint8), (64, 64))),
        ("deltas", np.tile(np.array(row[:257], np.uint8), (16, 1))),
        ("bitmap", _bitmap_image()),
        ("two_bit", _two_bit_image()),
        ("four_bit", _four_bit_image()),
        ("noise", np.random.default_rng(0).integers(
            0, 256, (256, 512)).astype(np.uint8)),
    ]


IMAGES = dict(_images())
SCHEME = {"bitmap": 1, "two_bit": 2, "four_bit": 4, "noise": None}


def _bits(buf):
    return int(buf[:16].view(np.uint32)[2])


def _jax_decode(buf, h, w):
    return np.asarray(jwc.decode_u8(buf, h, w, _bits(buf)))


def _torch_decode(buf, h, w):
    out = twc.decode_u8(torch.from_numpy(buf), h, w, _bits(buf))
    assert out.dtype == torch.uint8 and out.shape == (h, w)
    return out.numpy()


def _check_codec(img):
    """Encoders byte-equal, both decodes of the buffer equal to the image;
    returns the buffer (None when both encoders refuse)."""
    ref = jwc._encode_u8_numpy(img)
    buf = twc._encode_u8_numpy(img)
    if ref is None:
        assert buf is None and twc.encode_u8(img) is None
        return None
    assert buf is not None and buf.dtype == np.uint8
    np.testing.assert_array_equal(buf, ref)
    np.testing.assert_array_equal(twc.encode_u8(img), ref)
    h, w = img.shape
    np.testing.assert_array_equal(_jax_decode(buf, h, w), img)
    np.testing.assert_array_equal(_torch_decode(buf, h, w), img)
    return buf


@pytest.mark.parametrize("name", list(IMAGES))
def test_encoder_and_decoder_match_jax(name):
    img = IMAGES[name]
    buf = _check_codec(img)
    if name in SCHEME:
        want = SCHEME[name]
        assert (None if buf is None else _bits(buf)) == want


def test_1080p_scene_matches_jax():
    img = _make_scene(0, 1080, 1920)
    buf = _check_codec(img)
    assert buf is not None and buf.size < img.size // 2


@pytest.mark.parametrize("name", ["smooth", "bitmap", "two_bit", "four_bit"])
def test_decoders_agree_on_corrupt_buffers(name):
    """One byte flipped after the header, at seeded places: the port's
    decoder gives the JAX decoder's image bit for bit, whatever it is."""
    img = IMAGES[name]
    h, w = img.shape
    buf = jwc._encode_u8_numpy(img)
    rng = np.random.default_rng(len(name))
    used = int(np.flatnonzero(buf)[-1]) + 1
    moved = 0
    for at in rng.integers(16, used, 4):
        bad = buf.copy()
        bad[at] ^= np.uint8(rng.integers(1, 256))
        want = _jax_decode(bad, h, w)
        np.testing.assert_array_equal(_torch_decode(bad, h, w), want)
        moved += int(not np.array_equal(want, img))
    assert moved > 0


def test_decode_refuses_unknown_scheme():
    buf = jwc._encode_u8_numpy(IMAGES["smooth"])
    with pytest.raises(ValueError, match="bits=3"):
        twc.decode_u8(torch.from_numpy(buf), 240, 384, 3)


@pytest.mark.parametrize("name", ["smooth", "noise"])
def test_digest_is_blake2b_of_the_image(name):
    img = IMAGES[name]
    buf, digest = twc.encode_u8_digest(img)
    assert digest == hashlib.blake2b(img.tobytes(), digest_size=16).digest()
    ref = jwc._encode_u8_numpy(img)
    assert (buf is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(buf, ref)


@pytest.mark.parametrize("case", ["small", "float", "noise", "codec"])
def test_upload_image_u8_on_the_cpu(case, monkeypatch):
    """Raw when the image is small, not u8 or refused by the encoder;
    through the codec otherwise.  Either way the image, on the device."""
    img = {"small": IMAGES["smooth"][:200, :300],
           "float": IMAGES["smooth"].astype(np.float32) / 255,
           "noise": IMAGES["noise"],
           "codec": IMAGES["smooth"][:, :300]}[case]
    assert img.size >= 64 * 1024 or case == "small"
    decodes = []
    real = twc.decode_u8
    monkeypatch.setattr(twc, "decode_u8",
                        lambda *a: decodes.append(a[1:]) or real(*a))
    out = twc.upload_image_u8(img, "cpu")
    assert out.device.type == "cpu" and tuple(out.shape) == img.shape
    assert out.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(out.numpy(), img)
    want = ([(*img.shape, _bits(twc.encode_u8(img)))] if case == "codec"
            else [])
    assert decodes == want


def test_codec_upload_into_extraction_on_the_cpu():
    """The slice on the CPU: a 256x256 scene (64 Ki pixels, so the codec
    is used) through upload_image_u8 gives the features of the array."""
    img = _make_scene(1, 256, 256)
    assert twc.encode_u8(img) is not None
    dev = twc.upload_image_u8(img, "cpu")
    got = extract_features(dev, pt.Config(), "cpu")
    want = extract_features(img, pt.Config(), "cpu")
    assert want.get_feature_count() > 0
    sa, sb = got.soa(), want.soa()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    np.testing.assert_array_equal(got.get_descriptors(),
                                  want.get_descriptors())

