"""Single-image SIFT extraction on one device.

The counterpart of ``popsift_tpu.extract`` + ``popsift_tpu.staged``:
:func:`make_plan` gives the static per-octave shapes and capacities, and
:func:`extract_features` runs the stages as the staged extractor does:
the pyramid and keypoints of every octave (:func:`octave_keypoints_all`),
the grid filter over all of them (:func:`filter_extrema`), then
orientation and descriptors octave by octave (:func:`octave_features`),
reading the candidate, extremum and orientation counts back to the host
between stages (shapes are dynamic on the GPU, so there are no compile
buckets).  Each phase runs in a :func:`~popsift_torch.tracing.scope`
(pyramid, detect, filter, orientation, descriptors, download, assemble),
and with ``POPSIFT_TPU_HOSTTRACE=1`` the extraction, each octave's two
stages, the filter and the assembly are host spans, with the counts read
back per image as series.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (Config, DescMode, GaussMode, NormMode, ScalingMode,
                     SiftMode, check_supported)
from .constants import ConstInfo, build_const_info
from .features import (FeaturesDev, FeaturesHost, assemble_features,
                       assemble_features_dev)
from .gauss import build_gauss_info
from .kernels.binwin import stack_kernels_enabled
from .kernels.detect import detect
from .kernels.grad import grad_field
from .kernels.refine import refine_compact, refine_params
from .ops import descriptors as ops_desc
from .ops import extrema as ops_ext
from .ops import filtergrid as ops_fg
from .ops import orientation as ops_ori
from .ops import pyramid as ops_pyr
from .tracing import host_trace, scope, span_key


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ExtractorPlan:
    """Static shape/strategy information for one (config, size)."""

    input_w: int
    input_h: int
    dims: tuple[tuple[int, int], ...]   # per-octave (w, h)
    levels: int
    octaves: int
    sift_mode: SiftMode
    gauss_mode: GaussMode
    scaling_mode: ScalingMode
    desc_mode: DescMode
    norm_mode: NormMode
    upscale_factor: float
    sigma0: float
    sigma_k: float
    peak_threshold: float
    edge_limit: float
    norm_multi: int
    filter_grid_size: int
    filter_max_extrema: int
    grid_filter_mode: object
    cand_caps: tuple[int, ...]
    ext_caps: tuple[int, ...]
    ori_caps: tuple[int, ...]
    ori_win: int
    desc_win: int


def make_plan(config: Config, width: int, height: int) -> ExtractorPlan:
    """Per-octave dims and capacities (popsift_tpu/extract.py:70-128)."""
    levels = max(2, config.levels)
    w, h = config.scaled_dims(width, height)
    octaves = config.num_octaves_for(width, height)
    dims = []
    for _ in range(octaves):
        dims.append((w, h))
        w, h = -(-w // 2), -(-h // 2)

    cand_caps, ext_caps, ori_caps = [], [], []
    for (w, h) in dims:
        voxels = w * h * levels
        if config.ext_capacity > 0:
            ext_cap = config.ext_capacity
        else:
            ext_cap = min(config.max_extrema,
                          max(512, _round_up(voxels // 256, 128)), 16384)
        cand_cap = min(max(config.max_extrema, 2 * ext_cap),
                       max(1024, _round_up(voxels // 64, 128)), 65536)
        if config.ori_capacity > 0:
            ori_cap = config.ori_capacity
        else:
            # max_orientations = 1.25x (sift_constants.cu:31)
            ori_cap = _round_up(ext_cap + ext_cap // 4, 128)
        cand_caps.append(cand_cap)
        ext_caps.append(ext_cap)
        ori_caps.append(ori_cap)

    return ExtractorPlan(
        input_w=width, input_h=height, dims=tuple(dims), levels=levels,
        octaves=octaves, sift_mode=config.sift_mode,
        gauss_mode=config.gauss_mode, scaling_mode=config.scaling_mode,
        desc_mode=config.desc_mode, norm_mode=config.norm_mode,
        upscale_factor=config.upscale_factor, sigma0=config.sigma,
        sigma_k=2.0 ** (1.0 / levels),
        peak_threshold=config.get_peak_threshold(),
        edge_limit=config.edge_limit, norm_multi=config.norm_multiplier,
        filter_grid_size=config.filter_grid_size,
        filter_max_extrema=config.filter_max_extrema,
        grid_filter_mode=config.grid_filter_mode,
        cand_caps=tuple(cand_caps), ext_caps=tuple(ext_caps),
        ori_caps=tuple(ori_caps),
        ori_win=ops_ori.ori_window_size(config.sigma, levels),
        desc_win=ops_desc.desc_window_size(config.sigma, levels))


def normalize_input(image: np.ndarray) -> np.ndarray:
    """uint8 -> [0,1] f32 (s_image.cu:147); float input passes through."""
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return np.asarray(image, dtype=np.float32)


def to_unit_image(image: np.ndarray, device) -> torch.Tensor:
    """The (H, W) input on ``device`` as f32 in [0, 1]: bytes are uploaded
    and scaled on the device by 1/255 as the staged extractor does; other
    input is normalised on the host first (popsift_tpu/pipeline.py:374)."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint8:
        t = torch.as_tensor(image).to(device)
        return t.to(torch.float32) * (1.0 / 255.0)
    return torch.as_tensor(normalize_input(image)).to(device)


def refine_params_for(plan: ExtractorPlan, o: int, n_layers: int):
    w, h = plan.dims[o]
    g = plan.filter_grid_size
    return refine_params(
        plan.sift_mode, w, h, n_layers, plan.sigma0, plan.sigma_k,
        plan.peak_threshold, plan.edge_limit, w / g, h / g, g)


def octave_keypoints(plan: ExtractorPlan, o: int, dog: torch.Tensor):
    """Detection -> compaction -> refinement -> compaction of one octave.
    Returns (Candidates, Extrema)."""
    mask = detect(dog, plan.sift_mode, plan.peak_threshold)
    cands = ops_ext.compact_mask(mask, plan.cand_caps[o])
    return cands, refine_compact(dog, cands,
                                 refine_params_for(plan, o, dog.shape[0]),
                                 plan.ext_caps[o])


def descriptor_rows(plan: ExtractorPlan, o: int, num_ori: torch.Tensor,
                    orientations: torch.Tensor):
    """One row per (extremum, orientation) in feature order, clamped at
    the octave's orientation capacity.  Returns (feature index, angle,
    num_ori clamped to the rows produced)."""
    dev = num_ori.device
    n = num_ori.shape[0]
    incl = torch.cumsum(num_ori.to(torch.int64), 0)
    total = int(incl[-1]) if n else 0
    rows = min(total, plan.ori_caps[o])
    feat = torch.repeat_interleave(torch.arange(n, device=dev),
                                   num_ori.to(torch.int64))[:rows]
    first = incl - num_ori.to(torch.int64)
    k = torch.arange(rows, device=dev) - first[feat]
    ang = orientations[feat, k]
    num_eff = torch.clamp(torch.minimum(num_ori.to(torch.int64),
                                        rows - first), min=0)
    return feat, ang, num_eff.to(torch.int32)


def _quantize(desc: torch.Tensor, mode: str, norm_multi: int):
    """The integer steps of Config.desc_transfer (staged.py:
    _quantize_descs) as float32, and the float32 size of one step."""
    bound = 2.0 ** norm_multi
    levels = 65535.0 if mode == "u16" else 255.0
    q = torch.round(torch.clamp(desc, 0.0, bound) * (levels / bound))
    return q, np.float32(bound / levels)


def quantize_descs(desc: torch.Tensor, mode: str, norm_multi: int):
    """Rounding of Config.desc_transfer (staged.py:_quantize_descs) and
    back to float32, as the user receives the descriptors."""
    if mode == "f32":
        return desc.cpu().numpy()
    q, step = _quantize(desc, mode, norm_multi)
    dt = np.uint16 if mode == "u16" else np.uint8
    return q.cpu().numpy().astype(dt).astype(np.float32) * step


def quantize_descs_dev(desc: torch.Tensor, mode: str,
                       norm_multi: int) -> torch.Tensor:
    """:func:`quantize_descs` on the descriptors' device, as the JAX
    package's steady state dequantises them there (staged.py
    _dequantize_descs_dev): the same integer steps times the same float32
    step size, one float32 multiplication each, so the result equals the
    host array bit for bit."""
    if mode == "f32":
        return desc
    q, step = _quantize(desc, mode, norm_multi)
    return q * float(step)


def dispatch_descriptors(plan: ExtractorPlan, consts: ConstInfo | None,
                         stack, field, xpos, ypos, lpos, sigma, ang,
                         stack_kernels: bool = False):
    """Descriptor-mode dispatch (popsift_tpu/extract.py:185-237).  Loop
    descriptors read the gradient field (K6), or the stack (K11) with
    ``stack_kernels``.  The sampling modes read the blurred stack through
    per-row windows, which their kernels read straight from the stack:
    NoTile and IGrid, which compute the same numbers, with K9 and
    ``consts``' two descriptor tables on the stack's device; Grid with K12
    and ILoop with K13."""
    if plan.desc_mode == DescMode.LOOP:
        return ops_desc.loop_descriptors(
            field, xpos, ypos, lpos, sigma, ang, plan.desc_win,
            stack=stack if stack_kernels else None)
    if plan.desc_mode == DescMode.GRID:
        return ops_desc.grid_rounded_descriptors_windowed(
            stack, xpos, ypos, lpos, sigma, ang, plan.desc_win)
    if plan.desc_mode == DescMode.ILOOP:
        return ops_desc.iloop_descriptors_windowed(
            stack, xpos, ypos, lpos, sigma, ang, plan.desc_win)
    return ops_desc.grid_descriptors_windowed(
        stack, xpos, ypos, lpos, sigma, ang, plan.desc_win,
        consts.desc_gauss, consts.desc_tile)


def octave_features(plan: ExtractorPlan, o: int, stack, ext,
                    desc_transfer: str, field=None,
                    consts: ConstInfo | None = None,
                    stack_kernels: bool = False,
                    want_dev: bool = False) -> dict:
    """Orientation and descriptors of octave ``o``'s extrema ``ext``; host
    arrays, but with ``want_dev`` the descriptors (``desc``) stay a
    float32 tensor on the device.  With ``stack_kernels``, orientation and
    loop descriptors read ``stack`` (K10, K11); otherwise they read
    ``field``, computed from ``stack`` (K2) unless it is given.  ``consts``
    is needed by the NoTile and IGrid modes only."""
    dev = ext.xpos.device
    with scope("orientation", dev):
        if not stack_kernels and field is None:
            field = grad_field(stack)
        num_ori, oris = ops_ori.assign_orientations(
            field, ext.xpos, ext.ypos, ext.lpos, ext.sigma,
            stack=stack if stack_kernels else None)
        feat, ang, num_eff = descriptor_rows(plan, o, num_ori, oris)
    with scope("descriptors", dev):
        desc = dispatch_descriptors(plan, consts, stack, field,
                                    ext.xpos[feat], ext.ypos[feat],
                                    ext.lpos[feat], ext.sigma[feat], ang,
                                    stack_kernels)
        if plan.norm_mode == NormMode.ROOT_SIFT:
            desc = ops_desc.normalize_rootsift(desc, plan.norm_multi)
        else:
            desc = ops_desc.normalize_l2(desc, plan.norm_multi)
    with scope("download", dev):
        return dict(x=ext.xpos.cpu().numpy(), y=ext.ypos.cpu().numpy(),
                    sigma=ext.sigma.cpu().numpy(),
                    num_ori=num_eff.cpu().numpy(),
                    orientations=oris.cpu().numpy(),
                    desc=(quantize_descs_dev if want_dev else quantize_descs)(
                        desc, desc_transfer, plan.norm_multi),
                    overflow=ext.overflow)


def extract_octave_features(plan: ExtractorPlan, o: int, stack, dog,
                            desc_transfer: str, field=None,
                            consts: ConstInfo | None = None,
                            stack_kernels: bool = False,
                            want_dev: bool = False) -> dict:
    """Everything after the pyramid for octave ``o`` without the grid
    filter: :func:`octave_keypoints` on ``dog``, then
    :func:`octave_features`."""
    _, ext = octave_keypoints(plan, o, dog)
    return octave_features(plan, o, stack, ext, desc_transfer, field=field,
                           consts=consts, stack_kernels=stack_kernels,
                           want_dev=want_dev)


def octave_keypoints_all(plan: ExtractorPlan, gauss, img: torch.Tensor,
                         full_stacks: bool, need_field: bool,
                         dogs: list | None = None) -> list:
    """Stage 1 of every octave (popsift_tpu staged.py:158-245): the
    pyramid, DoG and field, then detection and refinement.  ``img`` is
    the [0, 1] input on the device.  Returns per octave (stack, field,
    Extrema); each DoG is dropped once its keypoints are found, unless
    ``dogs`` is a list, which then receives them."""
    out = []
    src = img
    key = span_key()
    n_cands = n_ext = 0
    for o in range(plan.octaves):
        host_trace(f"stage1.o{o}.start", key)
        with scope("pyramid", img.device):
            stack, src, dog, field = ops_pyr.octave_outputs(
                src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
                plan.upscale_factor, full_stacks, need_field=need_field,
                gauss_mode=plan.gauss_mode, scaling_mode=plan.scaling_mode,
                image=img)
        with scope("detect", img.device):
            cands, ext = octave_keypoints(plan, o, dog)
        host_trace(f"stage1.o{o}.end", key)
        n_cands += cands.count
        n_ext += ext.count
        out.append((stack, field, ext))
        if dogs is not None:
            dogs.append(dog)
        del dog
    host_trace("candidates", key, n=n_cands)
    host_trace("extrema", key, n=n_ext)
    return out


def filter_extrema(plan: ExtractorPlan, exts: list) -> list:
    """The grid filter over every octave's extrema when
    ``filter_max_extrema > 0`` (popsift_tpu staged.py:240-245), else
    ``exts`` as they are."""
    if plan.filter_max_extrema <= 0:
        return exts
    keeps = ops_fg.grid_filter_keep_masks(
        exts, plan.filter_max_extrema, plan.filter_grid_size,
        plan.grid_filter_mode)
    return [ops_fg.recompact(e, k) for e, k in zip(exts, keeps)]


def extract_features(image, config: Config, device="cuda",
                     want_dev: bool = False, return_pyramid: bool = False
                     ) -> FeaturesHost | FeaturesDev | tuple:
    """Extract the features of one (H, W) uint8 or [0,1] float image:
    a :class:`FeaturesHost`, or with ``want_dev`` a :class:`FeaturesDev`
    whose descriptors stay on ``device`` (MatchingMode), equal to the
    host descriptors bit for bit.  :func:`stack_kernels_enabled` is read
    once, here, and holds for the whole image.  Every octave's stack and
    field stay on the device until its descriptors are done, since the
    grid filter needs every octave's extrema first.

    With ``return_pyramid`` (the ``--log`` dump tree) it returns
    (features, stacks, dogs): per octave its whole (L+3, H, W) stack and
    (L+2, H, W) DoG on ``device`` (popsift_tpu extract_pipeline with
    return_pyramid).  Chain octaves then emit their whole stack, whose
    features are the same bit for bit."""
    key = span_key()
    host_trace("extract.start", key)
    check_supported(config)
    h, w = np.shape(image)
    plan = make_plan(config, w, h)
    gauss = build_gauss_info(config)
    img = to_unit_image(image, device)
    stack_kernels = stack_kernels_enabled()
    # the sampling descriptor modes and the stack kernels read every
    # blurred level, and the loop mode's field path only the field, so
    # chain octaves then keep only level L-3 (popsift_tpu staged.py:
    # 180-182); NoTile and IGrid need the two descriptor tables
    full_stacks = (plan.desc_mode != DescMode.LOOP or stack_kernels
                   or return_pyramid)
    consts = (build_const_info(config, device=device)
              if plan.desc_mode in (DescMode.NOTILE, DescMode.IGRID)
              else None)
    dogs = [] if return_pyramid else None
    stage1 = octave_keypoints_all(plan, gauss, img, full_stacks,
                                  need_field=not stack_kernels, dogs=dogs)
    stacks = [s for s, _, _ in stage1] if return_pyramid else None
    host_trace("filter.start", key)
    with scope("filter", img.device):
        exts = filter_extrema(plan, [e for _, _, e in stage1])
    host_trace("filter.end", key)
    octaves = []
    for o, ext in enumerate(exts):
        stack, field, _ = stage1[o]
        stage1[o] = None          # free the octave once it is done
        host_trace(f"stage2.o{o}.start", key)
        octaves.append(octave_features(
            plan, o, stack, ext, config.desc_transfer, field=field,
            consts=consts, stack_kernels=stack_kernels, want_dev=want_dev))
        host_trace(f"stage2.o{o}.end", key)
    host_trace("descriptors", key,
               n=sum(int(od["desc"].shape[0]) for od in octaves))
    host_trace("assemble.start", key)
    with scope("assemble", img.device):
        if want_dev:
            feats = assemble_features_dev(octaves, plan.upscale_factor,
                                          device)
        else:
            feats = assemble_features(octaves, plan.upscale_factor)
    host_trace("assemble.end", key)
    host_trace("extract.end", key)
    if return_pyramid:
        return feats, stacks, dogs
    return feats


__all__ = ["ExtractorPlan", "make_plan", "normalize_input",
           "extract_features"]
