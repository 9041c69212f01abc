"""msa_tpu — k-way multiple-sequence alignment in JAX, on NVIDIA GPUs.

Built from scratch in JAX / XLA with CUDA kernels, with the capabilities of
the reference OpenMP+OpenMPI aligner (``yangxvlin/multiple-sequence-alignment-
openMP-openMPI``): it solves k-way
MSA by sum of pairwise alignments — the optimal global Needleman–Wunsch
alignment (minimum penalty, linear gap cost) for all k(k-1)/2 sequence pairs —
and emits the reference's exact output contract: a SHA-512 chain hash over all
pairwise alignments in canonical task order plus the list of pairwise
penalties (reference driver: ``submit/xuliny-seqalkway.cpp:35-77``).

Architecture:

- ``msa_tpu.ops``      — compute kernels: NumPy oracle, jnp anti-diagonal
                         sweep, the device fill + walk (CUDA via jax.ffi,
                         with a plain-JAX twin).
- ``msa_tpu.models``   — problem-level drivers: pairwise aligner, k-way
                         sum-of-pairs engine.
- ``msa_tpu.parallel`` — deterministic LPT pair scheduling, device mesh /
                         sharding, multi-host collectives (replaces the
                         reference's MPI master-worker protocol).
- ``msa_tpu.utils``    — I/O contract, SHA-512 chaining, alignment string
                         algebra, timing.
- ``msa_tpu.native``   — C++ host runtime (sequential oracle, traceback
                         walker) loaded via ctypes.
"""

__version__ = "0.1.0"

from msa_tpu.utils.msaio import parse_input, format_output  # noqa: F401
from msa_tpu.models.kway import KWayAligner, align_kway  # noqa: F401
