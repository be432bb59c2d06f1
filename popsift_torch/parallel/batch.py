"""The multi-device SfM front end over torch.distributed
(popsift_tpu/parallel/batch.py).

The reference has no distributed runtime: "multi-GPU" is one PopSift
instance per device (SURVEY.md section 2.7, popsift.h:158-168).  The JAX
package's scaling model, ported here, is the SfM front end's batch:

* **data parallelism** over images: a batch of same-sized images is split
  over the ``data`` axis of a (data, model) mesh of ranks, and each rank
  extracts its images one after another, with no collective inside an
  image;
* **model parallelism** over matching: the right-hand descriptors are
  split over the ``model`` axis, each rank finds a best and second best
  against its column block, and the global top two come from an
  all_gather of those candidates over the model axis.

The model is SPMD, one process per rank: every rank calls the same
function with the same global inputs and returns the same global result
on its own device, where JAX returns arrays sharded over the mesh.  Rank
``r`` sits at ``(r // model, r % model)``, as
``np.asarray(devices).reshape(data, model)`` places JAX's devices.

Collectives run on the backend the caller gave ``init_process_group``:
NCCL for one card per rank, gloo for ranks that share a card (NCCL
refuses two ranks on one GPU) or run on the CPU.  gloo's all_gather takes
CUDA tensors as they are (chip_smoke.py phase 11 (b) runs it so).
Nothing switches backends by itself.

Not ported: the psum that lets shard_map's checker prove the matcher's
result replicated (batch.py:235-245; each rank here combines the same
gathered candidates), ``vmap`` with the Pallas kernels disabled in
:func:`batched_extractor` (a TPU workaround: the legacy form runs through
the same per-rank loop), and the settled-key store (the default key is
always :func:`_default_key`; :func:`key_from_counts` builds one from an
image's counts).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, check_supported
from ..extract import (ExtractorPlan, extract_octaves, image_keypoints,
                       make_plan, to_unit_image)
from ..gauss import build_gauss_info
from ..kernels.binwin import stack_kernels_enabled
from ..ops.match import match_brute_force


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh of the process group's
    ranks.  ``data_group`` holds the ranks of this rank's model index (its
    members ``data_ranks``, by data index) and ``model_group`` those of its
    data index (``model_ranks``, by model index)."""

    data: int
    model: int
    coords: tuple[int, int]
    data_ranks: tuple[int, ...]
    model_ranks: tuple[int, ...]
    data_group: object
    model_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        """The axis sizes by name, as a JAX Mesh's ``shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def _default_device() -> torch.device:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                           "to run the plain versions")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n)


def make_mesh(data: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the ranks of the initialised default
    process group (batch.py:45-54).  Every rank must call it, in the same
    order as its other group calls: it creates every row and column group
    on every rank.  ``device`` defaults to ``cuda:{LOCAL_RANK %
    device_count}``; ranks that share a card name it (``cuda:0``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if model < 1 or data < 1 or data * model != world:
        raise ValueError(f"make_mesh: data={data} x model={model} is not "
                         f"the world size {world}")
    data_ranks = [tuple(d * model + m for d in range(data))
                  for m in range(model)]
    model_ranks = [tuple(d * model + m for m in range(model))
                   for d in range(data)]
    data_groups = [dist.new_group(list(r)) for r in data_ranks]
    model_groups = [dist.new_group(list(r)) for r in model_ranks]
    d, m = divmod(rank, model)
    dev = _default_device() if device is None else torch.device(device)
    return Mesh(data=data, model=model, coords=(d, m),
                data_ranks=data_ranks[m], model_ranks=model_ranks[d],
                data_group=data_groups[m], model_group=model_groups[d],
                device=dev)


def _all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked in the group's rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def pad_batch(images: np.ndarray, mesh: Mesh):
    """Pad a (B, H, W) image batch with zero frames to a multiple of the
    data axis (batch.py:57-76).  Returns (padded images, img_valid), the
    (B',) bool row of real frames; ``sfm_frontend_step`` masks the pad
    frames' descriptors and matches."""
    d = mesh.shape["data"]
    b = images.shape[0]
    bp = -(-b // d) * d
    valid = np.zeros((bp,), bool)
    valid[:b] = True
    if bp != b:
        images = np.concatenate(
            [images, np.zeros((bp - b,) + images.shape[1:],
                              images.dtype)], axis=0)
    return images, valid


def bucket(n: int, lo: int = 128) -> int:
    """Smallest quarter-power-of-two step >= n (128, 160, 192, 224, 256,
    320, ...), the JAX package's compile bucket (staged.py:48-60)."""
    if n <= 0:
        return 0
    if n <= lo:
        return lo
    p = 1 << (n - 1).bit_length()
    half = p // 2
    step = max(half // 4, lo // 4)
    k = -(-(n - half) // step)
    return half + k * step


def _round_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _default_key(plan: ExtractorPlan, per_octave: int = 128) -> tuple:
    """The key (cks, ks, bs, ft, bt) when none is given (batch.py:101-113):
    every per-octave bucket at ``per_octave`` slots, clamped to the plan's
    capacities.  ``overflow`` reports only part of what it drops
    (:class:`KeyedExtractor`)."""
    b = bucket(per_octave)
    cks = tuple(min(b, plan.cand_caps[o]) for o in range(plan.octaves))
    ks = tuple(min(cks[o], plan.ext_caps[o]) for o in range(plan.octaves))
    bs = tuple(min(ks[o], plan.ori_caps[o]) for o in range(plan.octaves))
    return (cks, ks, bs, sum(ks), sum(bs))


def _first_bucket(count: int, cap: int) -> int:
    # staged.py _update_buckets_locked's step from an empty key: 1.5x
    # headroom, a 128-slot floor, clamped at the capacity
    return min(max(bucket(int(count * 1.5) + 1), 128), cap)


def key_from_counts(plan: ExtractorPlan, counts, ori_counts) -> tuple:
    """A key in the form the JAX extractor settles on after one image
    (``_last_key5``, staged.py:1512-1594), from that image's per-octave
    extrema ``counts`` and descriptor rows ``ori_counts``, with every
    candidate the plan holds refined (cks = the plan's candidate
    capacities).  The plan's capacities are the reference's, not the JAX
    package's buffers (:func:`make_plan`), so the key's ``cks`` and its
    clamps are not the JAX key's: an octave of more than 65,536 candidates
    or 16,384 extrema keeps them here.  Every count fits its bucket, so
    the image extracts under the key as under the plan."""
    o_range = range(plan.octaves)
    ks = tuple(_first_bucket(c, plan.ext_caps[o])
               for o, c in zip(o_range, counts))
    bs = tuple(_first_bucket(c, plan.ori_caps[o])
               for o, c in zip(o_range, ori_counts))
    ext_total = sum(min(int(c), ks[o]) for o, c in zip(o_range, counts))
    ori_total = sum(min(int(c), bs[o]) for o, c in zip(o_range, ori_counts))
    ft = min(_first_bucket(ext_total, sum(plan.ext_caps)), sum(ks))
    bt = min(_first_bucket(ori_total, sum(plan.ori_caps)), sum(bs))
    return (tuple(plan.cand_caps), ks, bs, ft, bt)


def _check_key(plan: ExtractorPlan, key) -> tuple:
    cks, ks, bs, ft, bt = key
    if not len(cks) == len(ks) == len(bs) == plan.octaves:
        raise ValueError(f"key {key}: needs {plan.octaves} octaves")
    return (tuple(int(c) for c in cks), tuple(int(k) for k in ks),
            tuple(int(b) for b in bs), int(ft), int(bt))


class KeyedExtractor:
    """One image's extraction under a key (cks, ks, bs, ft, bt): the
    counterpart of the JAX ``StagedExtractor._packed_soa_image`` followed
    by ``_dequantize_descs_dev`` (staged.py:823-845, 1139-1145), from this
    package's own stages with the key's per-octave caps in place of the
    plan's."""

    def __init__(self, config: Config, width: int, height: int,
                 device) -> None:
        check_supported(config)
        self.config = config
        self.plan = make_plan(config, width, height)
        self.device = torch.device(device)

    def keyed_plan(self, key: tuple) -> ExtractorPlan:
        """The plan with the key's caps: candidates compacted at cks,
        refined survivors at the JAX stage 1b's buffer
        min(ext_cap, max(ck, 128)) (staged.py:_stage1b_body), descriptor
        rows at bs (_stage3_body)."""
        cks, _, bs = key[:3]
        p = self.plan
        return dataclasses.replace(
            p, cand_caps=tuple(min(c, k) for c, k in zip(p.cand_caps, cks)),
            ext_caps=tuple(min(e, max(k, 128))
                           for e, k in zip(p.ext_caps, cks)),
            ori_caps=tuple(bs))

    def __call__(self, image, key: tuple) -> dict:
        """``desc``: the (max(bt, 1), 128) float32 descriptor block on the
        device, every octave's rows after the previous ones' (the finalize
        layout, staged.py:416-480), zeros after ``ori_total`` rows;
        ``ori_total`` and ``ext_total``, the rows and extrema within the
        key; ``overflow``, the refined survivors beyond their buffer plus
        the rows beyond bs (batch.py:155-157).

        Only what the JAX stages count counts: candidates beyond cks and
        extrema beyond ks (the first ks are oriented, _stage2_body) are
        dropped without a mark in ``overflow``."""
        _, ks, bs, _, bt = key
        res, _, _ = extract_octaves(image, self.config,
                                    self.keyed_plan(key), self.device,
                                    want_dev=True, ks=ks)
        ori_total = int(res.desc.shape[0])
        n = min(ori_total, max(bt, 1))
        desc = torch.zeros((max(bt, 1), 128), dtype=torch.float32,
                           device=self.device)
        desc[:n] = res.desc[:n]
        return dict(desc=desc, ori_total=ori_total,
                    ext_total=int(res.octave.shape[0]),
                    overflow=sum(v + max(c - b, 0) for v, c, b in
                                 zip(res.overflow, res.ori_count, bs)))


def _global_batch(images, height: int, width: int):
    """The (B, H, W) batch: a tensor as it is, on its own device (each
    image moves to the rank's device as it is extracted), other input as a
    numpy array."""
    if not isinstance(images, torch.Tensor):
        images = np.asarray(images)
    if images.ndim != 3 or tuple(images.shape[1:]) != (height, width):
        raise ValueError(f"expected a (B, {height}, {width}) batch, got "
                         f"{images.shape}")
    return images


def _data_parallel(mesh: Mesh, images, one) -> tuple:
    """``one(image)``, a tuple of tensors of fixed shapes, for the images
    of this rank's data index one after another (the lax.scan of
    batch.py:156-164; ranks of one data index repeat the same images),
    gathered over the data axis: the same (B, ...) tensors on every
    rank."""
    b = images.shape[0]
    if b == 0 or b % mesh.data:
        raise ValueError(f"a batch of {b} images does not split over the "
                         f"data axis of {mesh.data}")
    per = b // mesh.data
    d = mesh.coords[0]
    outs = [one(images[i]) for i in range(d * per, (d + 1) * per)]
    return tuple(_all_gather(mesh.data_group,
                             torch.stack(parts)).flatten(0, 1)
                 for parts in zip(*outs))


def staged_batched_extractor(config: Config, width: int, height: int,
                             mesh: Mesh, key: tuple | None = None):
    """Data-parallel batched extraction under one key (batch.py:131-184);
    ``key`` defaults to :func:`_default_key`.  Returns (fn, extractor,
    key), where ``fn(images)`` takes the global (B, H, W) batch (float in
    [0, 1] or uint8, the same on every rank) and returns, on every rank,
    ``desc`` (B, max(bt, 1), 128) float32 and ``ori_total``,
    ``ext_total``, ``overflow`` (B,) int32 on the mesh's device.  B must
    divide by the data axis."""
    ex = KeyedExtractor(config, width, height, mesh.device)
    key = _default_key(ex.plan) if key is None else _check_key(ex.plan, key)

    def one(image):
        r = ex(image, key)
        counts = torch.tensor([r["ori_total"], r["ext_total"],
                               r["overflow"]], dtype=torch.int32,
                              device=mesh.device)
        return r["desc"], counts

    def fn(images):
        desc, counts = _data_parallel(
            mesh, _global_batch(images, height, width), one)
        return dict(desc=desc, ori_total=counts[:, 0],
                    ext_total=counts[:, 1], overflow=counts[:, 2])

    return fn, ex, key


def batched_extractor(config: Config, width: int, height: int, mesh: Mesh):
    """The legacy form (batch.py:79-98): returns (fn, plan), where
    ``fn(images)`` gives ``{"octaves": [{"count": (B,)}, ...]}``, each
    octave's extrema under the plan's capacities (after the grid filter),
    through the same per-rank loop."""
    check_supported(config)
    plan = make_plan(config, width, height)
    gauss = build_gauss_info(config)

    def one(image):
        stage1, _ = image_keypoints(plan, gauss,
                                    to_unit_image(image, mesh.device),
                                    stack_kernels_enabled())
        return (torch.tensor([e.count for _, _, e in stage1],
                             dtype=torch.int32, device=mesh.device),)

    def fn(images):
        (counts,) = _data_parallel(
            mesh, _global_batch(images, height, width), one)
        return {"octaves": [{"count": counts[:, o]}
                            for o in range(plan.octaves)]}

    return fn, plan


def _local_top2(l_desc, r_desc, r_valid):
    """Best and second best of each left row against a column block:
    (v1, i1, v2, i2), squared distances and int32 block indices, from
    ops/match.py's product in IEEE float32 (batch.py:176-189)."""
    i1, i2, _, v1, v2 = match_brute_force(l_desc, r_desc, r_valid=r_valid)
    return v1, i1, v2, i2


def _take_min2(cv: torch.Tensor, ci: torch.Tensor):
    """The two smallest of each row's candidates, first index on ties."""
    rows = torch.arange(cv.shape[0], device=cv.device)
    b1 = torch.argmin(cv, dim=-1)
    cv2 = cv.clone()
    cv2[rows, b1] = float("inf")
    b2 = torch.argmin(cv2, dim=-1)
    return cv[rows, b1], ci[rows, b1], cv2[rows, b2], ci[rows, b2]


def sharded_match(mesh: Mesh, ratio: float = 0.8):
    """The sharded brute-force matcher (batch.py:191-270).  Returns
    ``fn(l_desc (N, D), r_desc (M, D), r_valid (M,))`` on global inputs:
    rank (d, m) matches row block d of ``l_desc`` against column block m
    of ``r_desc``, the per-block candidates are gathered over the model
    axis in block order and reduced to the global top two, and the rows
    are gathered over the data axis.  Every rank returns (N,) best_idx,
    second_idx (int32), accept (bool), best_dist and second_dist (float32,
    squared).  N must divide by the data axis and M by the model axis."""
    def fn(l_desc, r_desc, r_valid):
        dev = mesh.device
        l_desc = torch.as_tensor(l_desc).to(dev, torch.float32)
        r_desc = torch.as_tensor(r_desc).to(dev, torch.float32)
        r_valid = torch.as_tensor(r_valid).to(dev, torch.bool)
        n, m_cols = l_desc.shape[0], r_desc.shape[0]
        if n % mesh.data or m_cols % mesh.model:
            raise ValueError(f"sharded_match: {n} rows over data={mesh.data}"
                             f", {m_cols} columns over model={mesh.model}")
        d, m = mesh.coords
        rows, cols = n // mesh.data, m_cols // mesh.model
        v1, i1, v2, i2 = _local_top2(
            l_desc[d * rows:(d + 1) * rows],
            r_desc[m * cols:(m + 1) * cols],
            r_valid[m * cols:(m + 1) * cols])
        base = m * cols
        cand_v = _all_gather(mesh.model_group,
                             torch.stack([v1, v2], dim=-1))   # (S, rows, 2)
        cand_i = _all_gather(mesh.model_group,
                             torch.stack([i1 + base, i2 + base], dim=-1))
        s = cand_v.shape[0]
        # shard-major: a row's candidates are shard 0's pair, then shard 1's
        cv = cand_v.transpose(0, 1).reshape(rows, 2 * s)
        ci = cand_i.transpose(0, 1).reshape(rows, 2 * s)
        g1v, g1i, g2v, g2i = _take_min2(cv, ci)
        accept = g1v / g2v < ratio
        # one gather of the five rows, the distances by their bits
        out = _all_gather(mesh.data_group, torch.stack(
            [g1i, g2i, accept.to(torch.int32), g1v.view(torch.int32),
             g2v.view(torch.int32)]))                        # (D, 5, rows)
        out = out.transpose(0, 1).reshape(5, n)
        return (out[0], out[1], out[2].to(torch.bool),
                out[3].view(torch.float32), out[4].view(torch.float32))

    return fn


def sfm_frontend_step(config: Config, width: int, height: int, mesh: Mesh,
                      desc_cap: int = 1024, key: tuple | None = None):
    """The multi-device step (batch.py:271-336): batched extraction over
    the data axis, then matching of each image against the next with the
    right-hand descriptors over the model axis.  Returns (run, plan);
    ``run(images, img_valid=None)`` gives ``ext_counts`` (1, B),
    ``overflow`` (B,), ``desc`` (B, cap, 128), ``desc_valid`` (B, cap) and
    ``match_counts`` (B-1,), with cap = ``desc_cap`` bounded by the key's
    descriptor total and rounded up to 8 rows a rank.  A descriptor row is
    valid below the image's ``ori_total`` clamped at min(bt, cap), and not
    in a frame that ``img_valid`` marks as padding."""
    extract_fn, ex, key = staged_batched_extractor(config, width, height,
                                                   mesh, key)
    bt = max(key[4], 1)
    cap = _round_to(min(bt, max(desc_cap, 8)), mesh.size * 8)
    clamp = min(bt, cap)
    match = sharded_match(mesh)
    dev = mesh.device

    def run(images, img_valid=None):
        result = extract_fn(images)
        desc = result["desc"]
        b = desc.shape[0]
        if cap <= desc.shape[1]:
            desc = desc[:, :cap]
        else:
            desc = torch.nn.functional.pad(
                desc, (0, 0, 0, cap - desc.shape[1]))
        ot = torch.clamp(result["ori_total"], max=clamp)
        valid = (torch.ones(b, dtype=torch.bool, device=dev)
                 if img_valid is None else
                 torch.as_tensor(img_valid).to(dev, torch.bool))
        dvalid = ((torch.arange(cap, device=dev)[None, :] < ot[:, None])
                  & valid[:, None])
        counts = [(match(desc[i], desc[i + 1], dvalid[i + 1])[2]
                   & dvalid[i]).sum() for i in range(b - 1)]
        match_counts = (torch.stack(counts).to(torch.int32) if counts
                        else torch.zeros(0, dtype=torch.int32, device=dev))
        return dict(ext_counts=result["ext_total"][None, :],
                    overflow=result["overflow"], desc=desc,
                    desc_valid=dvalid, match_counts=match_counts)

    return run, ex.plan
