"""Single-image SIFT extraction on one device.

The counterpart of ``popsift_tpu.extract`` + ``popsift_tpu.staged``:
:func:`make_plan` gives the static per-octave shapes and capacities, and
:func:`extract_octaves` runs the stages as the staged extractor does:
the pyramid and keypoints of every octave (:func:`octave_keypoints_all`),
the grid filter over all of them (:func:`filter_extrema`; the two are
:func:`image_keypoints`), then stage 2, orientation and descriptors, in
one pass over the extrema of every octave (:func:`stage2_features`: one
orientation launch, one descriptor launch and one download an image,
each kernel taking a table of the octaves), which :func:`extract_features`
assembles.  They read the candidate and extremum counts back to the host
per octave in stage 1 and the descriptor rows once in stage 2 (shapes are
dynamic on the GPU, so there are no compile buckets).  Each phase runs in
a :func:`~popsift_torch.tracing.scope` (pyramid, detect, filter,
orientation, descriptors, download, assemble).  With the host-span
recorder on (``POPSIFT_TPU_HOSTTRACE=1`` or ``tracing.enable()``) the
extraction (``extract``), each octave's stage 1 (``stage1.o<k>``), the
stage-2 pass (``stage2``) and each scope are host spans on the
profiler's clock, under the job's request when a pipeline worker runs it;
every point where the host waits for the card is a ``readback.<site>``
span inside them (``rows`` and ``download`` here, ``compact`` and
``refine_status`` in the compaction and K4's wrapper, ``recompact`` in
the grid filter); the candidate, extremum and descriptor counts and the
octaves of the stage-2 pass (``stage2.octaves``) are series.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (Config, DescMode, GaussMode, NormMode, ScalingMode,
                     SiftMode, check_supported)
from .constants import ORIENTATION_MAX_COUNT, ConstInfo, build_const_info
from .features import (FeaturesDev, FeaturesHost, assemble_features,
                       assemble_features_dev)
from .gauss import build_gauss_info
from .kernels.binwin import (desc_loop_octaves, desc_loop_stack_octaves,
                             ori_peaks_octaves, ori_peaks_stack_octaves,
                             stack_kernels_enabled)
from .kernels.desc_grid import (desc_grid_rounded_stack_octaves,
                                desc_grid_stack_octaves,
                                desc_iloop_stack_octaves)
from .kernels.detect import detect
from .kernels.grad import grad_field
from .kernels.refine import refine_compact, refine_params
from .ops import descriptors as ops_desc
from .ops import extrema as ops_ext
from .ops import filtergrid as ops_fg
from .ops import orientation as ops_ori
from .ops import pyramid as ops_pyr
from . import tracing
from .tracing import scope


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


def to_unit_image(image, device) -> torch.Tensor:
    """The (H, W) input on ``device`` as f32 in [0, 1]: bytes are uploaded
    and scaled on the device by 1/255 as the staged extractor does; other
    input is normalised on the host first (popsift_tpu/pipeline.py:374).
    A tensor is taken as it is, from the device it lies on."""
    if isinstance(image, torch.Tensor):
        t = image.to(device)
    else:
        image = np.ascontiguousarray(image)
        if image.dtype != np.uint8:
            return torch.as_tensor(normalize_input(image)).to(device)
        t = torch.as_tensor(image).to(device)
    if t.dtype == torch.uint8:
        return t.to(torch.float32) * (1.0 / 255.0)
    return t.to(torch.float32)


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


def descriptor_rows(plan: ExtractorPlan, octs, counts, num_ori: torch.Tensor,
                    orientations: torch.Tensor):
    """One row per (extremum, orientation) in feature order, for the
    extrema of the octaves ``octs`` (``counts[i]`` of octave ``octs[i]``,
    end to end), each octave's rows clamped at its own orientation
    capacity.  The running row count is read back in one copy (the one
    ``readback.rows``), which gives each octave's rows before the clamp;
    the rows themselves are made on the device with no further sync.
    Returns (feature index, angle, num_ori clamped to the rows produced
    (int64), and per octave the rows before and after the clamp)."""
    num = num_ori.to(torch.int64)
    incl = torch.cumsum(num, 0)
    ends = np.cumsum(counts)
    run = np.concatenate(([0], tracing.to_host(incl, "readback.rows")))
    before = np.diff(run[ends], prepend=0).tolist()
    rows = [min(b, plan.ori_caps[o]) for o, b in zip(octs, before)]
    s = 0
    for c, b, r in zip(counts, before, rows):
        if r < b:
            # the clamp bites: the octave keeps its first r rows
            seg = num[s:s + c]
            first = incl[s:s + c] - seg - int(run[s])
            seg.copy_(torch.clamp(torch.minimum(seg, r - first), min=0))
        s += c
    total = sum(rows)
    feat = torch.repeat_interleave(num, output_size=total)
    k = torch.arange(total, device=num.device) \
        - (torch.cumsum(num, 0) - num)[feat]
    return feat, orientations[feat, k], num, before, rows


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
        return tracing.to_host(desc, "readback.download")
    q, step = _quantize(desc, mode, norm_multi)
    dt = np.uint16 if mode == "u16" else np.uint8
    return (tracing.to_host(q, "readback.download").astype(dt)
            .astype(np.float32) * step)


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
                         stacks, fields, counts, xpos, ypos, lpos, sigma,
                         ang, stack_kernels: bool = False):
    """Descriptor-mode dispatch (popsift_tpu/extract.py:185-237), one
    launch over the rows of every octave: ``counts[i]`` rows of the octave
    whose blurred stack is ``stacks[i]`` and gradient field ``fields[i]``.
    Loop descriptors read the field (K6), or the stack (K11) with
    ``stack_kernels``.  The sampling modes read the blurred stack through
    per-row windows, which their kernels read straight from the stack:
    NoTile and IGrid, which compute the same numbers, with K9 and
    ``consts``' two descriptor tables on the stack's device; Grid with K12
    and ILoop with K13."""
    rows = (counts, xpos, ypos, lpos, sigma, ang)
    if plan.desc_mode == DescMode.LOOP:
        if stack_kernels:
            return desc_loop_stack_octaves(stacks, *rows, plan.desc_win // 2)
        return desc_loop_octaves(fields, *rows, plan.desc_win // 2)
    if plan.desc_mode == DescMode.GRID:
        return desc_grid_rounded_stack_octaves(stacks, *rows, plan.desc_win)
    if plan.desc_mode == DescMode.ILOOP:
        return desc_iloop_stack_octaves(stacks, *rows, plan.desc_win)
    return desc_grid_stack_octaves(stacks, *rows, plan.desc_win,
                                   consts.desc_gauss, consts.desc_tile)


def stage2_features(plan: ExtractorPlan, octaves: list, desc_transfer: str,
                    consts: ConstInfo | None = None,
                    stack_kernels: bool = False,
                    want_dev: bool = False) -> list:
    """Stage 2 of the octaves ``octaves``, each (o, stack, field, Extrema)
    in ascending o, in one pass: the extrema of every octave end to end,
    one orientation launch (K5, or K10 with ``stack_kernels``), one
    :func:`descriptor_rows`, one descriptor launch, one normalisation and
    quantisation, and one download of two arrays (the keypoints' numbers
    packed, and the descriptors).  Returns per octave a dict of host
    arrays (``x, y, sigma, num_ori, orientations, desc``, slices of the
    download), but with ``want_dev`` the descriptors (``desc``) stay a
    float32 tensor on the device; ``overflow`` and ``ori_count``, the
    octave's descriptor rows before the orientation capacity's clamp.
    Orientation and loop descriptors read each octave's ``field``, or
    ``stack`` with ``stack_kernels``; a field left None is computed from
    the stack (K2).  ``consts`` is needed by the NoTile and IGrid modes
    only."""
    dev = octaves[0][3].xpos.device
    live = [(o, st, f, e) for o, st, f, e in octaves if e.count]
    octs = [o for o, _, _, _ in live]
    counts = [e.count for _, _, _, e in live]
    if tracing.HOSTTRACE:
        tracing.host_trace("stage2.octaves", None, n=len(live))
    meta = np.zeros((0, 4 + ORIENTATION_MAX_COUNT), np.float32)
    desc = (torch.zeros((0, 128), dtype=torch.float32, device=dev)
            if want_dev else np.zeros((0, 128), np.float32))
    before = rows = []
    if live:
        stacks = [st for _, st, _, _ in live]
        fields = None
        with scope("orientation", dev):
            if not stack_kernels:
                fields = [grad_field(st) if f is None else f
                          for _, st, f, _ in live]
            x, y, lpos, sigma = (
                torch.cat([getattr(e, k) for _, _, _, e in live])
                for k in ("xpos", "ypos", "lpos", "sigma"))
            if stack_kernels:
                num_ori, oris = ori_peaks_stack_octaves(stacks, counts, x, y,
                                                        lpos, sigma)
            else:
                num_ori, oris = ori_peaks_octaves(fields, counts, x, y, lpos,
                                                  sigma)
            feat, ang, num_eff, before, rows = descriptor_rows(
                plan, octs, counts, num_ori, oris)
        with scope("descriptors", dev):
            d = dispatch_descriptors(plan, consts, stacks, fields, rows,
                                     x[feat], y[feat], lpos[feat],
                                     sigma[feat], ang, stack_kernels)
            if plan.norm_mode == NormMode.ROOT_SIFT:
                d = ops_desc.normalize_rootsift(d, plan.norm_multi)
            else:
                d = ops_desc.normalize_l2(d, plan.norm_multi)
        with scope("download", dev):
            meta = tracing.to_host(torch.cat(
                (x[:, None], y[:, None], sigma[:, None],
                 num_eff[:, None].to(torch.float32), oris), dim=1),
                "readback.download")
            desc = (quantize_descs_dev if want_dev else quantize_descs)(
                d, desc_transfer, plan.norm_multi)
    # per octave its rows before and after the clamp
    counted = dict(zip(octs, zip(before, rows)))
    out = []
    s = r = 0
    for o, _, _, e in octaves:
        total, n_rows = counted.get(o, (0, 0))
        m = meta[s:s + e.count]
        out.append(dict(x=m[:, 0], y=m[:, 1], sigma=m[:, 2],
                        num_ori=m[:, 3].astype(np.int32),
                        orientations=m[:, 4:], desc=desc[r:r + n_rows],
                        overflow=e.overflow, ori_count=total))
        s += e.count
        r += n_rows
    return out


def extract_octave_features(plan: ExtractorPlan, o: int, stack, dog,
                            desc_transfer: str, field=None,
                            consts: ConstInfo | None = None,
                            stack_kernels: bool = False,
                            want_dev: bool = False) -> dict:
    """Everything after the pyramid for octave ``o`` without the grid
    filter: :func:`octave_keypoints` on ``dog``, then
    :func:`stage2_features` of the octave alone."""
    _, ext = octave_keypoints(plan, o, dog)
    return stage2_features(plan, [(o, stack, field, ext)], desc_transfer,
                           consts=consts, stack_kernels=stack_kernels,
                           want_dev=want_dev)[0]


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
    n_cands = n_ext = 0
    for o in range(plan.octaves):
        sp = tracing.begin(f"stage1.o{o}") if tracing.HOSTTRACE else None
        with scope("pyramid", img.device):
            stack, src, dog, field = ops_pyr.octave_outputs(
                src, o, plan.dims, plan.levels, gauss, plan.sift_mode,
                plan.upscale_factor, full_stacks, need_field=need_field,
                gauss_mode=plan.gauss_mode, scaling_mode=plan.scaling_mode,
                image=img)
        with scope("detect", img.device):
            cands, ext = octave_keypoints(plan, o, dog)
        if sp is not None:
            tracing.end(sp)
        n_cands += cands.count
        n_ext += ext.count
        out.append((stack, field, ext))
        if dogs is not None:
            dogs.append(dog)
        del dog
    if tracing.HOSTTRACE:
        tracing.host_trace("candidates", None, n=n_cands)
        tracing.host_trace("extrema", None, n=n_ext)
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


def image_keypoints(plan: ExtractorPlan, gauss, img: torch.Tensor,
                    stack_kernels: bool, return_pyramid: bool = False):
    """Stage 1 of every octave of ``img`` (the [0, 1] input on the device)
    and the grid filter: per octave (stack, field, Extrema), the extrema
    filtered, and the DoGs (None unless ``return_pyramid``, which also
    keeps every chain octave's whole stack)."""
    # the sampling descriptor modes and the stack kernels read every
    # blurred level, and the loop mode's field path only the field, so
    # chain octaves then keep only level L-3 (popsift_tpu staged.py:
    # 180-182)
    full_stacks = (plan.desc_mode != DescMode.LOOP or stack_kernels
                   or return_pyramid)
    dogs = [] if return_pyramid else None
    stage1 = octave_keypoints_all(plan, gauss, img, full_stacks,
                                  need_field=not stack_kernels, dogs=dogs)
    with scope("filter", img.device):
        exts = filter_extrema(plan, [e for _, _, e in stage1])
    return ([(s, f, e) for (s, f, _), e in zip(stage1, exts)], dogs)


def _first(ext: ops_ext.Extrema, k: int) -> ops_ext.Extrema:
    if ext.count <= k:
        return ext
    return ext._replace(xpos=ext.xpos[:k], ypos=ext.ypos[:k],
                        lpos=ext.lpos[:k], sigma=ext.sigma[:k],
                        cell=ext.cell[:k], count=k)


def extract_octaves(image, config: Config, plan: ExtractorPlan, device,
                    want_dev: bool = False, ks: tuple | None = None,
                    return_pyramid: bool = False) -> tuple:
    """Stage 1, the grid filter and stage 2 of one (H, W) image under
    ``plan``: per octave the dict of :func:`octave_features`.  With ``ks``
    only the first ``ks[o]`` extrema of octave o go on to stage 2 (a
    compile bucket's clamp; their ``overflow`` is not raised).
    :func:`stack_kernels_enabled` is read once, here, and holds for the
    whole image.  Every octave's stack and field stay on the device until
    its descriptors are done, since the grid filter needs every octave's
    extrema first.  Returns (octaves, stacks, dogs), the last two None
    unless ``return_pyramid``."""
    img = to_unit_image(image, device)
    stack_kernels = stack_kernels_enabled()
    # NoTile and IGrid need the two descriptor tables
    consts = (build_const_info(config, device=device)
              if plan.desc_mode in (DescMode.NOTILE, DescMode.IGRID)
              else None)
    stage1, dogs = image_keypoints(plan, build_gauss_info(config), img,
                                   stack_kernels, return_pyramid)
    stacks = [s for s, _, _ in stage1] if return_pyramid else None
    octs = [(o, stack, field, ext if ks is None else _first(ext, ks[o]))
            for o, (stack, field, ext) in enumerate(stage1)]
    del stage1
    sp = tracing.begin("stage2") if tracing.HOSTTRACE else None
    octaves = stage2_features(plan, octs, config.desc_transfer,
                              consts=consts, stack_kernels=stack_kernels,
                              want_dev=want_dev)
    if sp is not None:
        tracing.end(sp)
    if tracing.HOSTTRACE:
        tracing.host_trace("descriptors", None,
                           n=sum(int(od["desc"].shape[0]) for od in octaves))
    return octaves, stacks, dogs


def extract_features(image, config: Config, device="cuda",
                     want_dev: bool = False, return_pyramid: bool = False
                     ) -> FeaturesHost | FeaturesDev | tuple:
    """Extract the features of one (H, W) uint8 or [0,1] float image:
    a :class:`FeaturesHost`, or with ``want_dev`` a :class:`FeaturesDev`
    whose descriptors stay on ``device`` (MatchingMode), equal to the
    host descriptors bit for bit (:func:`extract_octaves`, then the
    assembly).

    With ``return_pyramid`` (the ``--log`` dump tree) it returns
    (features, stacks, dogs): per octave its whole (L+3, H, W) stack and
    (L+2, H, W) DoG on ``device`` (popsift_tpu extract_pipeline with
    return_pyramid).  Chain octaves then emit their whole stack, whose
    features are the same bit for bit.

    With the recorder on, the call is an ``extract`` host span, closed
    also when the extraction raises."""
    sp = tracing.begin("extract") if tracing.HOSTTRACE else None
    try:
        check_supported(config)
        h, w = np.shape(image)
        plan = make_plan(config, w, h)
        octaves, stacks, dogs = extract_octaves(
            image, config, plan, device, want_dev=want_dev,
            return_pyramid=return_pyramid)
        with scope("assemble", device):
            if want_dev:
                feats = assemble_features_dev(octaves, plan.upscale_factor,
                                              device)
            else:
                feats = assemble_features(octaves, plan.upscale_factor)
    finally:
        if sp is not None:
            tracing.end(sp)
    if return_pyramid:
        return feats, stacks, dogs
    return feats


__all__ = ["ExtractorPlan", "make_plan", "normalize_input",
           "extract_features"]
