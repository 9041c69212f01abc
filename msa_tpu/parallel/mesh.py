"""Device-mesh helpers.

The reference scaled over MPI ranks on up to 12 nodes
(``testing15/template.slurm``); here the scaling axes are a
``jax.sharding.Mesh``: a ``pairs`` axis (data parallel over the pair queue —
the axis that carried all of the reference's speedup) and an optional
``wave`` axis reserved for intra-pair wavefront parallelism (the S3 analog).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def get_mesh(
    n_devices: Optional[int] = None, axis_name: str = "pairs"
) -> Mesh:
    # Local devices: under several processes jax.devices() lists every
    # process's devices, and a mesh over devices this process cannot drive
    # would hang.
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))

