"""Rank bodies of the multi-rank tests of ``popsift_torch.parallel``.

``popsift_torch.parallel.ranks.run_ranks`` starts each rank in a fresh
process, which imports its function by module path: these live here,
apart from the test files, so that a rank imports torch and the port but
not JAX.  Each returns numpy arrays, compared in the test process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from popsift_torch import config as tcfg
from popsift_torch.parallel import batch as tb


def _np(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def mesh_rank(rank: int, shapes, batches) -> dict:
    """Each mesh's coordinates, members and groups, and pad_batch of each
    batch size on it."""
    out = {}
    for data, model in shapes:
        mesh = tb.make_mesh(data=data, model=model, device="cpu")
        out[(data, model)] = dict(
            coords=mesh.coords, data_ranks=mesh.data_ranks,
            model_ranks=mesh.model_ranks,
            data_group=tuple(dist.get_process_group_ranks(mesh.data_group)),
            model_group=tuple(
                dist.get_process_group_ranks(mesh.model_group)),
            shape=mesh.shape,
            pads={b: tb.pad_batch(
                np.arange(b * 6, dtype=np.uint8).reshape(b, 2, 3), mesh)
                for b in batches})
    return out


def match_rank(rank: int, shapes, cases: dict) -> dict:
    """sharded_match on each mesh of each case (l, r, r_valid), and the
    errors of row and column counts the mesh does not divide."""
    out = {}
    for data, model in shapes:
        mesh = tb.make_mesh(data=data, model=model, device="cpu")
        match = tb.sharded_match(mesh)
        for name, (l, r, rv) in cases.items():
            out[(data, model, name)] = tuple(
                t.cpu().numpy() for t in match(l, r, rv))
        try:
            match(np.zeros((data * 8 + 1, 128), np.float32),
                  np.zeros((model * 8 + 1, 128), np.float32),
                  np.ones(model * 8 + 1, bool))
            out[(data, model, "indivisible")] = None
        except ValueError as e:
            out[(data, model, "indivisible")] = str(e)
    return out


def sfm_rank(rank: int, mesh_shape, cases: dict, width: int,
             height: int) -> dict:
    """sfm_frontend_step of each case (images, img_valid, desc_cap, key),
    the per-image results of staged_batched_extractor and the counts of
    batched_extractor (given a tensor) on the first case's images, and the
    error of a batch the data axis does not divide."""
    mesh = tb.make_mesh(*mesh_shape, device="cpu")
    cfg = tcfg.Config()
    out = {}
    for name, (images, img_valid, desc_cap, key) in cases.items():
        run, plan = tb.sfm_frontend_step(cfg, width, height, mesh,
                                         desc_cap=desc_cap, key=key)
        out[name] = _np(run(images, img_valid))
    images = next(iter(cases.values()))[0]
    fn, ex, key = tb.staged_batched_extractor(cfg, width, height, mesh)
    out["staged"] = _np(fn(images))
    out["staged_key"] = key
    legacy, _ = tb.batched_extractor(cfg, width, height, mesh)
    out["legacy"] = np.stack([od["count"].cpu().numpy() for od in
                              legacy(torch.as_tensor(images))["octaves"]])
    try:
        fn(images[:mesh.data + 1])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    out["jax_imported"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "popsift_tpu"))
    return out


def echo_rank(rank: int, x) -> tuple:
    """The rank, its world and ``x``, after a barrier of every rank."""
    dist.barrier()
    return rank, dist.get_world_size(), x


def failing_rank(rank: int) -> None:
    """Rank 1 raises at once; the others wait in a barrier that rank 1
    never reaches, as ranks do whose peer has failed."""
    if rank == 1:
        raise KeyError("rank 1 fails")
    dist.barrier()


def sleeping_rank(rank: int, seconds: float) -> None:
    """A rank that overruns its caller's time limit."""
    import time
    time.sleep(seconds)
