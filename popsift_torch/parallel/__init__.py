"""Multi-device SfM front end over torch.distributed (popsift_tpu/parallel).

:mod:`.batch` holds the mesh, the data-parallel extractors, the sharded
matcher and the step; :mod:`.ranks` starts ranks on one host;
:mod:`.dryrun` runs one step on n ranks (``python -m
popsift_torch.parallel.dryrun --ranks N --device cpu|cuda``).
"""

from .batch import (Mesh, batched_extractor, key_from_counts, make_mesh,
                    pad_batch, sfm_frontend_step, sharded_match,
                    staged_batched_extractor)

__all__ = ["Mesh", "batched_extractor", "key_from_counts", "make_mesh",
           "pad_batch", "sfm_frontend_step", "sharded_match",
           "staged_batched_extractor"]
