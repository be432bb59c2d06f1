"""Why the port's batched rows differ from JAX's on the blob images of
tests/test_parallel.py: the port's orientation code, given JAX's inputs,
gives JAX's orientation counts.

Each image of the even batch of tests/test_torch_parallel_batch.py puts
two features at the centres of round Gaussian blobs.  Their orientation
histograms are nearly symmetric, so which bins are peaks is decided by
the last bits of the keypoint and of the gradient field.  Here the
port's stage 1 (plain, on the CPU) and JAX's single-image extractor
(``get_extractor`` with ``return_pyramid``) find the same extrema, and
the port's ``assign_orientations`` runs on each feature with either
package's keypoint and either package's gradient field (the port's, or
the port's ``grad_field`` of JAX's own blurred stack).

* With JAX's keypoint on its own field, or with its own keypoint on
  JAX's stack, the port gives JAX's ``num_ori`` for every feature.
* With both of its own inputs it differs at one feature: image 1's blob
  at (43, 32), 3 orientations against JAX's 4.  There the port's
  refinement puts y one ulp above JAX's (31.999998 against 31.999996),
  and the histogram's int-truncated squared distances
  (s_orientation.cu:142) move window-edge pixels between rings: bins
  12-14 and 29-31 move by up to 1.45 and bin 9's peak appears only at
  JAX's y.  That is the one image whose batched rows differ from JAX's
  (test_blob_centres_are_the_counted_divergence).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from popsift_torch import config as tcfg  # noqa: E402
from popsift_torch import extract as text  # noqa: E402
from popsift_torch.gauss import build_gauss_info  # noqa: E402
from popsift_torch.kernels.grad import grad_field  # noqa: E402
from popsift_torch.ops.orientation import assign_orientations  # noqa: E402
from popsift_tpu import extract as jext  # noqa: E402
from test_torch_parallel_batch import H, W, _images  # noqa: E402

KEYS = ("x", "y", "lpos", "sigma")


@pytest.fixture(scope="module")
def octaves():
    """Per (image, octave) with extrema: the port's and JAX's keypoints
    (x, y, lpos, sigma), the port's field, the field of JAX's stack, and
    JAX's num_ori."""
    cfg = tcfg.Config()
    plan = text.make_plan(cfg, W, H)
    gauss = build_gauss_info(cfg)
    fn, _ = jext.get_extractor(tp.jax_config(cfg), W, H, return_pyramid=True)
    out = {}
    with tp.one_thread():
        for i, img in enumerate(_images(4)):
            stage1, _ = text.image_keypoints(
                plan, gauss, text.to_unit_image(img, "cpu"),
                stack_kernels=False, return_pyramid=True)
            ref = fn(jnp.asarray(img))
            for o, (_, field, e) in enumerate(stage1):
                od = ref["octaves"][o]
                valid = np.asarray(od["valid"])
                assert e.count == int(valid.sum()), (i, o)
                if not e.count:
                    continue
                jstack = torch.as_tensor(np.array(ref["pyramid"][o]))
                out[(i, o)] = dict(
                    port=(e.xpos, e.ypos, e.lpos, e.sigma),
                    jax=tuple(torch.as_tensor(np.asarray(od[k])[valid])
                              for k in KEYS),
                    field=field, jax_field=grad_field(jstack),
                    num_ori=np.asarray(od["num_ori"])[valid])
    return out


def _num_ori(kp, field) -> np.ndarray:
    with tp.one_thread():
        return assign_orientations(field, *kp)[0].numpy()


def test_the_same_extrema(octaves):
    assert len(octaves) == 6
    for (i, o), oc in octaves.items():
        px, py, pl, ps = (t.numpy() for t in oc["port"])
        jx, jy, jl, js = (t.numpy() for t in oc["jax"])
        np.testing.assert_array_equal(pl, jl)
        assert np.abs(px - jx).max() <= tp.XY_ATOL, (i, o)
        assert np.abs(py - jy).max() <= tp.XY_ATOL, (i, o)
        assert (np.abs(ps - js) <= tp.SIGMA_RTOL * js).all(), (i, o)


@pytest.mark.parametrize("inputs", ["jax keypoints, port field",
                                    "port keypoints, field of jax stack"])
def test_port_orientation_on_a_jax_input_gives_jax_num_ori(octaves, inputs):
    for key, oc in octaves.items():
        if inputs.startswith("jax"):
            got = _num_ori(oc["jax"], oc["field"])
        else:
            got = _num_ori(oc["port"], oc["jax_field"])
        np.testing.assert_array_equal(got, oc["num_ori"], err_msg=str(key))


def test_own_inputs_differ_at_image_1s_blob_centre_only(octaves):
    differ = []
    for (i, o), oc in octaves.items():
        got = _num_ori(oc["port"], oc["field"])
        for f in np.flatnonzero(got != oc["num_ori"]):
            differ.append((i, o, int(f), int(got[f]), int(oc["num_ori"][f])))
    assert differ == [(1, 1, 1, 3, 4)]
    oc = octaves[(1, 1)]
    x, y = (float(t[1]) for t in oc["port"][:2])
    assert (abs(x - 43.0), abs(y - 32.0)) < (1e-4, 1e-4)
    py, jy = np.float32(oc["port"][1][1]), np.float32(oc["jax"][1][1])
    assert np.nextafter(jy, np.float32(np.inf)) == py
