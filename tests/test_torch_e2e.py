"""popsift_torch end to end against popsift_tpu, both on the CPU.

``popsift_torch.PopSift(Config(), device="cpu")`` runs the plain PyTorch
version of every kernel; ``popsift_tpu.PopSift(Config())`` runs the XLA
forms.  Three images: the conftest ``textured_image`` (120x160) and
``blob_image``, and a 128x160 crop of ``tests/data/scenes/hopper.pgm``.

Two comparisons per image:

* **end to end**: feature and descriptor counts, octaves, num_ori and the
  descriptor index map exactly equal; xpos/ypos within 1e-3 px.  The blur
  levels of the two packages differ in the last bit (XLA:CPU contracts the
  blur's multiply-adds into FMAs, PyTorch rounds every operation, as the
  CUDA kernels do), and Newton refinement amplifies that into up to ~3e-4
  px of keypoint position.  Orientation and descriptors are then computed
  at a slightly different point, so three tolerances are loosened here:
  sigma rtol 1e-4 (not 1e-5), orientation 2e-3 rad (not 1e-4), and the
  u16-dequantised descriptors 1e-3 (not 2/65535).
* **after the pyramid**: the port's detection, refinement, orientation
  and descriptor stages run on the JAX package's own levels and DoG.
  With the blur rounding taken out, the tight tolerances hold: sigma rtol
  1e-5, orientation 1e-4 rad, descriptors within 2 u16 steps.

A feature whose orientation peaks tie (two of its highest peaks, or a
peak and the 0.8 x highest acceptance line, within 1e-3 relative) has its
angles decided by last-bit differences of atan2 between the two packages'
maths libraries; its angles and descriptors are not compared, and the
test bounds how many such features each image may have: one in a hundred
for textured and hopper (each has one).  The blob image's three features sit at the centres
of radially symmetric Gaussian blobs, whose gradient histograms are flat:
all of them tie by construction.

The NoTile descriptor mode is compared once more on ``textured_image``:
``extract_features(img, Config(desc_mode=notile), device="cpu")`` against
the JAX package's extractor (``get_extractor``, as test_desc_modes.py
runs it), with the end-to-end tolerances above.  Its orientation stage is
the loop mode's, so its keypoints must equal the port's own loop-mode
keypoints exactly.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import popsift_tpu  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from popsift_tpu import features as jfeat  # noqa: E402
from popsift_tpu import gauss as jgauss  # noqa: E402
from popsift_tpu.ops import pyramid as jpyr  # noqa: E402

import popsift_torch  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.features import assemble_features  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.kernels.binwin import ori_hist, peak_candidates  # noqa: E402
from popsift_torch.kernels.grad import grad_field  # noqa: E402
from popsift_torch.ops import pyramid as tpyr  # noqa: E402

IMAGES = ["textured", "blob", "hopper"]
# largest share of an image's features whose orientation peaks may tie
TIED_SHARE = {"textured": 0.01, "blob": 1.0, "hopper": 0.01}
TIE_RTOL = 1e-3
U16_STEP = 1.0 / 65535.0


@contextlib.contextmanager
def one_thread():
    """PyTorch's CPU kernels evaluate atan2 (and sqrt) in vector or scalar
    form depending on how a call is split across threads, which can move
    the last bit; on one thread, repeated computations are bit-equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _read_pgm(path: Path) -> np.ndarray:
    data = path.read_bytes()
    fields = []
    pos = 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    assert fields[0] == b"P5" and int(fields[3]) == 255
    w, h = int(fields[1]), int(fields[2])
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w)


def _hopper_crop() -> np.ndarray:
    img = _read_pgm(Path(__file__).parent / "data" / "scenes" / "hopper.pgm")
    return np.ascontiguousarray(img[176:304, 240:400])


def _jax_pyramid(img):
    cfg = popsift_tpu.Config()
    h, w = img.shape
    plan = jext.make_plan(cfg, w, h)
    gauss = jgauss.build_gauss_info(cfg)

    def fn(im):
        im = im.astype(jnp.float32) * (1.0 / 255.0)
        return jpyr.build_pyramid_and_dogs(
            im, gauss, plan.dims, plan.levels, plan.gauss_mode,
            plan.scaling_mode, plan.sift_mode, plan.upscale_factor)

    stacks, dogs = jax.jit(fn)(img)
    return [np.array(s) for s in stacks], [np.array(d) for d in dogs]


def _after_pyramid(img):
    """The port's stages after the pyramid, run on the JAX pyramid."""
    stacks, dogs = _jax_pyramid(img)
    cfg = popsift_torch.Config()
    plan = text.make_plan(cfg, img.shape[1], img.shape[0])
    octaves = [(o, torch.as_tensor(stacks[o]), None,
                text.octave_keypoints(plan, o, torch.as_tensor(dogs[o]))[1])
               for o in range(plan.octaves)]
    return assemble_features(
        text.stage2_features(plan, octaves, cfg.desc_transfer),
        plan.upscale_factor)


def _tied_features(img) -> np.ndarray:
    """Per feature (in FeaturesHost order), whether its orientation peaks
    tie, from the port's own stages."""
    cfg = popsift_torch.Config()
    plan = text.make_plan(cfg, img.shape[1], img.shape[0])
    gauss = build_gauss_info(cfg)
    src = text.to_unit_image(img, "cpu")
    tied = []
    for o in range(plan.octaves):
        stack, dog = tpyr.build_octave(src, o, plan.dims, plan.levels, gauss,
                                       plan.sift_mode, plan.upscale_factor)
        _, ext = text.octave_keypoints(plan, o, dog)
        src = stack
        if not ext.count:
            continue
        hist = ori_hist(grad_field(stack), ext.xpos, ext.ypos,
                        ext.lpos, ext.sigma)
        _, yval = peak_candidates(hist)
        for row in torch.sort(yval, dim=-1, descending=True).values.numpy():
            peaks = row[np.isfinite(row)].astype(np.float64)
            if peaks.size == 0:
                tied.append(False)
                continue
            line = 0.8 * peaks[0]
            n_acc = min(int((peaks >= line).sum()), 4)
            top = peaks[:n_acc + 1]
            tied.append(bool(
                (np.abs(np.diff(top)) <= TIE_RTOL * peaks[0]).any()
                or (np.abs(peaks - line) <= TIE_RTOL * peaks[0]).any()))
    return np.asarray(tied, bool)


@pytest.fixture(scope="module")
def results(textured_image, blob_image):
    images = {"textured": textured_image, "blob": blob_image,
              "hopper": _hopper_crop()}
    with popsift_tpu.PopSift(popsift_tpu.Config()) as ps:
        jobs = {k: ps.enqueue(im.shape[1], im.shape[0], im)
                for k, im in images.items()}
        ref = {k: j.get() for k, j in jobs.items()}
    with popsift_torch.PopSift(popsift_torch.Config(), device="cpu") as ps:
        jobs = {k: ps.enqueue(im.shape[1], im.shape[0], im)
                for k, im in images.items()}
        port = {k: j.get() for k, j in jobs.items()}
    after = {k: _after_pyramid(im) for k, im in images.items()}
    tied = {k: _tied_features(im) for k, im in images.items()}
    return ref, port, after, tied


def _angle_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _compare(ref, got, tied, sigma_rtol, ori_tol, desc_tol):
    assert got.get_feature_count() == ref.get_feature_count() > 0
    assert tied.shape == (ref.get_feature_count(),)
    assert got.get_descriptor_count() == ref.get_descriptor_count()
    rs, gs = ref._soa, got._soa
    for k in ("num_ori", "debug_octave", "desc_idx"):
        np.testing.assert_array_equal(gs[k], rs[k], err_msg=k)
    for k in ("xpos", "ypos"):
        np.testing.assert_allclose(gs[k], rs[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(gs["sigma"], rs["sigma"], rtol=sigma_rtol)
    has = (np.arange(4)[None, :] < rs["num_ori"][:, None]) & ~tied[:, None]
    dth = _angle_diff(gs["orientation"], rs["orientation"])[has]
    assert dth.max(initial=0.0) <= ori_tol, dth.max()
    rows = rs["desc_idx"][has]
    dd = np.abs(got.get_descriptors()[rows] - ref.get_descriptors()[rows])
    assert dd.max(initial=0.0) <= desc_tol, dd.max()


@pytest.mark.parametrize("image", IMAGES)
def test_end_to_end_matches(results, image):
    ref, port, _, tied = results
    _compare(ref[image], port[image], tied[image], sigma_rtol=1e-4,
             ori_tol=2e-3, desc_tol=1e-3)


@pytest.mark.parametrize("image", IMAGES)
def test_tied_orientation_peaks_are_rare(results, image):
    tied = results[3][image]
    assert tied.sum() <= TIED_SHARE[image] * tied.size, int(tied.sum())


@pytest.mark.parametrize("image", IMAGES)
def test_stages_after_the_pyramid_match(results, image):
    ref, _, after, tied = results
    # 2 u16 steps, plus the float32 rounding of the dequantised values
    _compare(ref[image], after[image], tied[image], sigma_rtol=1e-5,
             ori_tol=1e-4, desc_tol=2 * U16_STEP * (1 + 1e-6))


@pytest.mark.parametrize("image", IMAGES)
@pytest.mark.parametrize("as_uchar", [False, True])
def test_feature_text_output_matches(results, image, as_uchar):
    """Feature::print of the port gives the JAX package's text for the same
    features (x512 for the uchar form, so roundf's half-away-from-zero
    rounding is exercised)."""
    import io

    ref = results[0][image]
    scale = 512.0 if as_uchar else 1.0
    desc = (ref.get_descriptors() * np.float32(scale)).astype(np.float32)
    soa = {k: v.copy() for k, v in ref._soa.items()}
    jf = type(ref)(descriptors=desc, soa=soa)
    tf = popsift_torch.FeaturesHost(descriptors=desc.copy(), soa=soa)
    a, b = io.StringIO(), io.StringIO()
    jf.print(a, write_as_uchar=as_uchar)
    tf.print(b, write_as_uchar=as_uchar)
    assert b.getvalue() == a.getvalue()
    assert len(b.getvalue().splitlines()) == ref.get_descriptor_count()


@pytest.fixture(scope="module")
def notile(textured_image):
    img = textured_image
    h, w = img.shape
    jcfg = popsift_tpu.Config()
    jcfg.set_desc_mode(popsift_tpu.DescMode.NOTILE)
    fn, _ = jext.get_extractor(jcfg, w, h)
    ref = jfeat.assemble_features(fn(jext.normalize_input(img)),
                                  jcfg.get_upscale_factor())
    tcfg = popsift_torch.Config()
    tcfg.set_desc_mode(popsift_torch.DescMode.NOTILE)
    with one_thread():
        port = text.extract_features(img, tcfg, device="cpu")
        loop = text.extract_features(img, popsift_torch.Config(),
                                     device="cpu")
    return ref, port, _tied_features(img), loop


def test_notile_end_to_end_matches(notile):
    ref, port, tied, _ = notile
    _compare(ref, port, tied, sigma_rtol=1e-4, ori_tol=2e-3, desc_tol=1e-3)


def test_notile_keypoints_equal_loop_keypoints(notile):
    grid = notile[1].soa()
    loop = notile[3].soa()
    for k in ("xpos", "ypos", "sigma", "num_ori", "orientation",
              "debug_octave"):
        np.testing.assert_array_equal(grid[k], loop[k], err_msg=k)
