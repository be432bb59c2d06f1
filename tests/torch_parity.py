"""Helpers of the port's parity tests against the JAX package on the CPU.

``jax_features`` runs the JAX package's jitted extractor
(``popsift_tpu.extract.get_extractor``) and ``port_features`` the port's
``extract_features`` on the CPU, for the same settings given as a port
``Config`` (``jax_config`` copies it field by field).  ``compare`` holds
the two to the end-to-end tolerances of ``test_torch_e2e.py``: feature
and descriptor counts, octaves, num_ori and the descriptor index map
exactly; xpos/ypos within 1e-3 px, sigma rtol 1e-4, orientation 2e-3 rad
and descriptors 1e-3, leaving out the angles and descriptors of features
whose orientation peaks tie (``tied_features``).  Those tolerances and
the tie rule are explained in ``test_torch_e2e.py``'s docstring.

``check_images`` runs one setting on two 120x160 images, the conftest
``textured_image`` and a crop of ``tests/data/scenes/hopper.pgm`` (the
same size, so the JAX extractor compiles once for both).  On each, up to
2% of the features (OUTLIER_SHARE) may lie outside the position and
sigma tolerances: that is the counted rounding divergence of ROADMAP
Queue 3.  XLA:CPU contracts the blur's and the refinement's
multiply-adds into FMAs where the port rounds each operation, and the
Newton refinement of a feature whose fit is nearly degenerate amplifies
last-bit differences (a high octave's also by the octave's scale): with
``levels=4`` the port's refinement on the JAX package's own DoG already
moves one hopper feature's sigma by 4.2e-4 relative.  Measured: 5 of 284
hopper features with ``levels=4`` (sigma up to 3.2e-4 relative), one of
252 textured ones (1.6e-3 px), one of 223 in VLFeat mode (1.1e-3 px at
octave 3), and up to 2.1e-3 px and sigma 8.7e-4 relative with
``sigma=1.4``.  Those features' angles and descriptors are not compared,
and how many there were is printed.
"""

import contextlib
import dataclasses
import enum
from pathlib import Path

import numpy as np
import torch

from popsift_tpu import config as jcfg
from popsift_tpu import extract as jext
from popsift_tpu import features as jfeat

from popsift_torch import extract as text
from popsift_torch.gauss import build_gauss_info
from popsift_torch.kernels.binwin import ori_hist, peak_candidates
from popsift_torch.kernels.grad import grad_field

TIE_RTOL = 1e-3
# end-to-end tolerances of test_torch_e2e.py::test_end_to_end_matches
XY_ATOL, SIGMA_RTOL, ORI_TOL, DESC_TOL = 1e-3, 1e-4, 2e-3, 1e-3
# largest share of an image's features whose orientation peaks may tie,
# and that may lie outside the position and sigma tolerances
TIED_SHARE = 0.01
OUTLIER_SHARE = 0.02


@contextlib.contextmanager
def one_thread():
    """PyTorch's CPU kernels may move the last bit of atan2 and sqrt with
    the way a call is split across threads; one thread is repeatable."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def read_pgm(path: Path) -> np.ndarray:
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


def hopper_crop() -> np.ndarray:
    """A 120x160 crop of tests/data/scenes/hopper.pgm, the first 120 rows
    of the crop test_torch_e2e.py uses."""
    img = read_pgm(Path(__file__).parent / "data" / "scenes" / "hopper.pgm")
    return np.ascontiguousarray(img[176:296, 240:400])


def jax_config(cfg):
    """The JAX package's Config with the port Config's settings."""
    out = jcfg.Config()
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = type(getattr(out, f.name))(v.value)
        setattr(out, f.name, v)
    return out


def jax_features(img: np.ndarray, cfg):
    j = jax_config(cfg)
    h, w = img.shape
    fn, _ = jext.get_extractor(j, w, h)
    return jfeat.assemble_features(fn(jext.normalize_input(img)),
                                   j.get_upscale_factor())


def port_features(img: np.ndarray, cfg):
    with one_thread():
        return text.extract_features(img, cfg, device="cpu")


def tied_features(img: np.ndarray, cfg) -> np.ndarray:
    """Per feature (in FeaturesHost order), whether its orientation peaks
    tie, from the port's own stages with ``cfg``'s pyramid and grid
    filter: two of the highest peaks, or a peak and the 0.8 x highest
    acceptance line, within TIE_RTOL of the highest."""
    plan = text.make_plan(cfg, img.shape[1], img.shape[0])
    with one_thread():
        stage1 = text.octave_keypoints_all(
            plan, build_gauss_info(cfg), text.to_unit_image(img, "cpu"),
            full_stacks=True, need_field=True)
        exts = text.filter_extrema(plan, [e for _, _, e in stage1])
        tied = []
        for (stack, _, _), ext in zip(stage1, exts):
            if not ext.count:
                continue
            hist = ori_hist(grad_field(stack), ext.xpos, ext.ypos, ext.lpos,
                            ext.sigma)
            _, yval = peak_candidates(hist)
            for row in torch.sort(yval, dim=-1,
                                  descending=True).values.numpy():
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


def _angle_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def compare(ref, got, tied, most_outliers: int = 0) -> int:
    """``got`` (the port's FeaturesHost) against ``ref`` (the JAX
    package's) at the end-to-end tolerances; ``tied`` from
    :func:`tied_features`.  Up to ``most_outliers`` features may lie
    outside the position and sigma tolerances; their angles and
    descriptors are left out.  Returns how many did."""
    n = ref.get_feature_count()
    assert got.get_feature_count() == n > 0
    assert tied.shape == (n,)
    assert tied.sum() <= max(1, TIED_SHARE * n), int(tied.sum())
    assert got.get_descriptor_count() == ref.get_descriptor_count()
    rs, gs = ref._soa, got._soa
    for k in ("num_ori", "debug_octave", "desc_idx"):
        np.testing.assert_array_equal(gs[k], rs[k], err_msg=k)
    out = ((np.abs(gs["xpos"] - rs["xpos"]) > XY_ATOL)
           | (np.abs(gs["ypos"] - rs["ypos"]) > XY_ATOL)
           | (np.abs(gs["sigma"] - rs["sigma"])
              > SIGMA_RTOL * np.abs(rs["sigma"])))
    assert out.sum() <= most_outliers, (
        f"{int(out.sum())} features outside the position/sigma tolerances",
        np.flatnonzero(out))
    has = ((np.arange(4)[None, :] < rs["num_ori"][:, None])
           & ~(tied | out)[:, None])
    dth = _angle_diff(gs["orientation"], rs["orientation"])[has]
    assert dth.max(initial=0.0) <= ORI_TOL, dth.max()
    rows = rs["desc_idx"][has]
    dd = np.abs(got.get_descriptors()[rows] - ref.get_descriptors()[rows])
    assert dd.max(initial=0.0) <= DESC_TOL, dd.max()
    return int(out.sum())


def check_images(cfg, textured: np.ndarray, image=lambda im: im) -> None:
    """``cfg`` on the textured image and the hopper crop, the port against
    the JAX package (see the module docstring).  ``image`` turns each
    uint8 image into the input both packages get."""
    for name, img in (("textured", textured), ("hopper", hopper_crop())):
        ref = jax_features(image(img), cfg)
        got = port_features(image(img), cfg)
        tied = tied_features(image(img), cfg)
        n = ref.get_feature_count()
        try:
            off = compare(ref, got, tied, int(OUTLIER_SHARE * n))
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        print(f"{name}: {n} features, {int(tied.sum())} tied, {off} "
              f"outside the position/sigma tolerances")
