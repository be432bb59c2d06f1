"""Start a group of ranks on one host and collect what each returns.

:func:`run_ranks` starts one fresh Python process per rank (a new
interpreter, never a ``fork``: the parent may hold a CUDA context), each
of which joins a process group through a ``FileStore`` in a temporary
directory, calls ``fn(rank, *args)`` and writes its result back there.  A
rank sets ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``, runs with one CPU
thread, and on NCCL takes card ``rank % device_count`` first.  A rank that
raises, dies or overruns the time limit fails the call, and every rank
still running is then killed.  The ranks are the only processes a call
starts, and each has exited and been waited for when it returns.
"""

from __future__ import annotations

import datetime
import os
import pickle
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types

import torch
import torch.distributed as dist

# how long a collective (the rendezvous included) may wait for the other
# ranks before it fails instead of hanging
COLLECTIVE_TIMEOUT_S = 90.0
# how long the other ranks may take to report once one has failed
FAILURE_GRACE_S = 2.0

# a rank's interpreter: the parent's import path first, then the rank
_BOOT = ("import pickle, sys; sys.path[:] = pickle.load(open(sys.argv[1], "
         "'rb'))['path']; from popsift_torch.parallel.ranks import "
         "_rank_main; _rank_main(sys.argv[1], int(sys.argv[2]))")


def _load_main(name: str | None, path: str | None) -> None:
    """The parent's main module as ``__mp_main__`` (its ``__main__`` guard
    stays shut), by module name when it was run with ``-m``, else from its
    file, so that functions defined there unpickle."""
    main = types.ModuleType("__mp_main__")
    main.__dict__.update(
        runpy.run_module(name, run_name="__mp_main__") if name
        else runpy.run_path(path, run_name="__mp_main__"))
    sys.modules["__main__"] = sys.modules["__mp_main__"] = main


def _rank_main(job_path: str, rank: int) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    world, backend = job["world"], job["backend"]
    out_path = os.path.join(os.path.dirname(job_path), f"rank{rank}.pkl")
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    result = None
    try:
        if job["main"] is not None:
            _load_main(*job["main"])
        fn, args = pickle.loads(job["call"])
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(job["store"], world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = (True, fn(rank, *args), 0)
        except BaseException:
            # timed before the group goes down: a rank's failure is older
            # than those it brings about in its peers
            result = (False, traceback.format_exc(), time.time_ns())
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the call
        if result is None or result[0]:
            result = (False, traceback.format_exc(), time.time_ns())
    # written whole, then renamed: the parent reads only finished results
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(out_path + ".tmp", out_path)
    sys.exit(0 if result[0] else 1)


def run_ranks(fn, world: int, backend: str, args: tuple = (),
              timeout: float = 300.0) -> list:
    """``fn(rank, *args)`` on ``world`` ranks of a new process group on
    ``backend`` ("gloo" or "nccl"); returns their results by rank.  ``fn``
    and ``args`` must pickle (``fn`` by its import path; a function of the
    main script is found by running that script in the rank under another
    name), and so must each result.  Raises RuntimeError when a rank fails
    and TimeoutError when the ranks have not all returned within
    ``timeout`` seconds."""
    if world < 1:
        raise ValueError(f"run_ranks: world size {world}")
    main = None
    if getattr(fn, "__module__", None) == "__main__":
        mod = sys.modules["__main__"]
        spec = getattr(mod, "__spec__", None)
        path = getattr(mod, "__file__", None)
        if spec is None and path is None:
            raise ValueError(f"run_ranks: {fn!r} is defined in a main "
                             f"module without a file")
        main = ((spec.name, None) if spec is not None
                else (None, os.path.abspath(path)))
    tmp = tempfile.mkdtemp(prefix="popsift_ranks_")
    job_path = os.path.join(tmp, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(dict(path=list(sys.path), main=main, world=world,
                         backend=backend, store=os.path.join(tmp, "store"),
                         call=pickle.dumps((fn, args),
                                           protocol=pickle.HIGHEST_PROTOCOL)),
                    f, protocol=pickle.HIGHEST_PROTOCOL)
    procs: list = []
    out: dict = {}
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOT, job_path, str(r)]))
        deadline = time.monotonic() + timeout
        grace = None
        while len(out) < world:
            failed = []
            for r, p in enumerate(procs):
                if r in out or p.poll() is None:
                    continue
                path = os.path.join(tmp, f"rank{r}.pkl")
                if not os.path.exists(path):
                    raise RuntimeError(f"run_ranks: rank {r} exited with "
                                       f"{p.returncode} and no result")
                with open(path, "rb") as f:
                    ok, value, failed_at = pickle.load(f)
                if not ok:
                    failed.append((failed_at, r, value))
                elif p.returncode != 0:
                    raise RuntimeError(f"run_ranks: rank {r} returned its "
                                       f"result and exited with "
                                       f"{p.returncode}")
                else:
                    out[r] = value
            now = time.monotonic()
            if failed:
                # the first to fail is the cause: the ranks it brings down
                # get a moment to report, so that it is among those read
                grace = grace or now + FAILURE_GRACE_S
                if now > grace or all(p.poll() is not None for p in procs):
                    _, r, value = min(failed)
                    others = sorted(f[1] for f in failed if f[1] != r)
                    raise RuntimeError(
                        f"run_ranks: rank {r} of {world} failed"
                        + (f" (then rank(s) {others})" if others else "")
                        + f":\n{value}")
            elif len(out) < world and now > deadline:
                missing = [r for r in range(world) if r not in out]
                raise TimeoutError(
                    f"run_ranks: rank(s) {missing} of {world} gave no "
                    f"result within {timeout} s")
            if len(out) < world:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
