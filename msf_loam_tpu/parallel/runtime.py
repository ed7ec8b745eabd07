"""Multi-process runtime initialization.

The ``jax.distributed`` bootstrap for deployments that span several
processes — the communication-backend plank of SURVEY.md §2.9 (the
reference is single-process). After ``initialize()``, ``jax.devices()``
spans every process and every mesh built by ``parallel.mesh.make_mesh``
shards across them transparently.

Initialization is explicit only: it runs when a coordinator is given, as
an argument or as ``MSF_COORD=host:PORT`` with ``MSF_NUM_PROCESSES=N`` and
``MSF_PROCESS_ID=i``, and then a failure raises. With no coordinator it is
a no-op: one process on one host drives all of that host's devices itself
(a four-GPU host needs no distributed runtime), and the in-process
8-virtual-device CPU mesh (tests/conftest.py) needs none either.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger("msf_loam_tpu")

_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or the MSF_* env vars.

    Returns True if a multi-process runtime was started; False for
    single-process operation (no coordinator given).
    """
    global _initialized
    import jax

    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("MSF_COORD")
    if not coordinator:
        return False
    num_processes = num_processes or _int_env("MSF_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("MSF_PROCESS_ID")
    if not num_processes:
        raise ValueError(f"coordinator {coordinator!r} given without a "
                         f"process count (MSF_NUM_PROCESSES)")

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=int(num_processes),
                               process_id=int(process_id or 0))
    _initialized = True
    logger.info("jax.distributed initialized: process %d/%d @ %s",
                jax.process_index(), jax.process_count(), coordinator)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None
