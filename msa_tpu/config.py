"""Configuration system — the single source of kernel/engine tunables.

The reference had no flags at all — its config surfaces were compile-time
constants (``n_threads = 16`` at ``submit/xuliny-seqalkway.cpp:94``, the
``*8`` tile fudge at ``submit:452``) and Slurm environment (SURVEY.md §5).
Here every tunable is an explicit dataclass field, overridable from
environment variables prefixed ``MSA_TPU_``, read once when this module is
first imported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class EngineConfig:
    # Pairwise backend: numpy | native | jax | device | auto
    backend: str = "auto"
    # Below this m*n, pairs run on the host or the jnp sweep instead of the
    # device fill + walk (ops/nw_gpu). Set on an earlier accelerator; not
    # measured on the H100.
    small_threshold: int = 1 << 21
    # Bucket quantum for padded shapes (bounds recompilation).
    bucket_quantum: int = 256
    # Pair schedule policy for the multi-process engine: "calibrated" (LPT
    # over the measured wall-clock model: process 0 calibrates on its
    # GPU — cached on disk, so ~free after first use — and broadcasts the
    # parameters so every process derives the identical schedule; falls
    # back to "lpt" when calibration is unavailable), "lpt" (cost = m*n,
    # the reference's proven testing8 design), or "block" (the reference's
    # S1 layout, kept for parity).
    schedule_policy: str = "calibrated"
    # Local devices to shard the big pairs over WITHIN one process.
    # 0 = all local devices; 1 = single-device. Pairs are LPT-split and
    # each device runs the full fill + walk + decode (models/kway).
    local_devices: int = 0
    # Route a workload whose ONLY big pair cannot be pair-parallelized
    # through the band-striped cross-device fill (ops/nw_striped): every
    # local device fills a row stripe, boundary rows stream over the
    # mesh in K-chunks. Opt-in (0 = off).
    single_pair_striped: int = 0
    # Emit jax.profiler traces to this directory when set.
    profile_dir: Optional[str] = None

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        cfg = cls(**overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"MSA_TPU_{f.name.upper()}")
            if env is not None:
                cur = getattr(cfg, f.name)
                setattr(
                    cfg, f.name, int(env) if isinstance(cur, int) else env
                )
        return cfg


DEFAULT = EngineConfig.from_env()
