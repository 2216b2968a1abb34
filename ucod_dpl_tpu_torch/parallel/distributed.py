"""Process topology for the data layer and the eval loop, for one process.

Counterpart of :mod:`ucod_dpl_tpu.parallel.distributed` (``jax.distributed``
over a TPU pod).  The port runs one process: every function here answers
for a world of one (``process_shard`` is ``(0, 1)``, the gathers are the
identity, ``barrier`` returns at once).  A launch with ``WORLD_SIZE > 1``
raises in :func:`maybe_initialize_distributed`: multi-process runs over
``torch.distributed`` (NCCL on the cards, gloo on the CPU) are ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

import os
from typing import Any, List


def maybe_initialize_distributed() -> None:
    """A no-op in one process; raises NotImplementedError when the launcher
    asks for more (``WORLD_SIZE > 1``)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']}: multi-process runs over torch.distributed are not ported "
            "yet (ROADMAP Queue 1 item 13); run one process"
        )


def process_count() -> int:
    return 1


def process_shard() -> tuple:
    """(index, count) slice of the dataset this process reads."""
    return 0, process_count()


def is_main_process() -> bool:
    return True


def gather_object_lists(local: List[Any]) -> List[Any]:
    """Every process's list of arrays, in rank order: the local list in one
    process."""
    return gather_ragged(local)


def gather_ragged(local: List[Any]) -> List[Any]:
    """Ragged-count lists of equal-shape arrays from every process: the
    local list in one process."""
    return local


def barrier(name: str = "barrier") -> None:
    """Wait for every process: returns at once in one process."""
