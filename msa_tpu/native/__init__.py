"""C++ host runtime (loaded via ctypes).

Native equivalents of the reference's C++ components: the sequential NW
oracle (``seqalign-mpi-skeleton.cpp:186-280``) and the traceback walker.
Built from source at first use by ``msa_tpu/native/build.py``; a host with
no C++ compiler reports the kernel unavailable, a failing build raises.
The CUDA fill and walk (``nw_cuda.cu``) are loaded by ``msa_tpu.ops.nw_gpu``.
"""

from __future__ import annotations

from msa_tpu.native.lib import (  # noqa: F401
    native_available,
    nw_align_native,
    nw_score_native,
)
