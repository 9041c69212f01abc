"""Cost models for pair scheduling.

The reference tried three generations of cost model (SURVEY.md §2.2): the
analytic ``cost = m*n`` (``testing8``), a hard-coded table of measured
microseconds (``testing11/test.cpp:150-267``), and a fitted linear model
(``testing11/p1.cpp:186``). The analytic model is exact for DP *cells*, but
wall-clock per pair also carries per-pair fixed overhead (dispatch, padding
ramp) — this module provides both, plus on-device calibration that replaces
testing11's hard-coded table with measured throughput.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

# Bump when the fill kernels change materially: cached calibrations are
# keyed by (device kind, kernel version) and a stale throughput model
# would silently skew every calibrated schedule.
KERNEL_VERSION = "cuda-strip-1"


@dataclasses.dataclass
class CalibratedCost:
    """cost_us(m, n) = fixed_us + m*n / gcups / 1e3."""

    gcups: float = 60.0  # measured throughput per device
    fixed_us: float = 120_000.0  # per-pair dispatch + ramp overhead

    def cost_us(self, m: int, n: int) -> float:
        return self.fixed_us + m * n / self.gcups / 1e3


def _cache_path() -> str:
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(base, "msa_tpu", "calibration.json")


def _cache_key(device_kind: str, sample_len: int, small_len: int) -> str:
    return f"{device_kind}|{KERNEL_VERSION}|{sample_len}|{small_len}"


def load_cached_calibration(
    device_kind: str, sample_len: int, small_len: int
) -> Optional[CalibratedCost]:
    try:
        with open(_cache_path()) as f:
            data = json.load(f)
        rec = data.get(_cache_key(device_kind, sample_len, small_len))
        if rec:
            return CalibratedCost(
                gcups=float(rec["gcups"]), fixed_us=float(rec["fixed_us"])
            )
    except (OSError, ValueError, KeyError):
        pass
    return None


def save_calibration(
    device_kind: str, sample_len: int, small_len: int, model: CalibratedCost
) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[_cache_key(device_kind, sample_len, small_len)] = {
            "gcups": model.gcups,
            "fixed_us": model.fixed_us,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort; calibration still returned


def analytic_cost(m: int, n: int) -> int:
    """The reference's exact cell-count model (testing8)."""
    return m * n


def calibrate(
    sample_len: int = 20000, small_len: int = 2048, reps: int = 2,
    use_cache: bool = True,
) -> Optional[CalibratedCost]:
    """Measure throughput AND per-pair fixed cost of the device path.

    Two timed pair sizes solve cost(m, n) = fixed_us + cells/rate for both
    terms — the fixed term is the whole advantage of the measured model over
    analytic m*n (the reference's testing11 finding: small pairs cost far
    more than their cells predict, ``testing11/test.cpp:150-267``). Each
    sample times one pair through ``ops/nw_gpu.align_pairs`` (fill, walk
    and decode), which returns host values, so the timing includes the
    device work. Returns None without a GPU.

    Measuring costs seconds (compiles + timed reps), so results persist to
    ``~/.cache/msa_tpu/calibration.json`` keyed by device kind + kernel
    version; with a warm cache this function returns in microseconds, which
    is what makes ``schedule_policy=calibrated`` usable as a default (the
    reference's testing11 hard-coded its measured table into the source for
    the same reason).
    """
    import jax

    if jax.default_backend() != "gpu":
        return None
    device_kind = jax.local_devices()[0].device_kind
    if use_cache:
        cached = load_cached_calibration(device_kind, sample_len, small_len)
        if cached is not None:
            return cached
    import numpy as np

    from msa_tpu.ops.nw_gpu import align_pairs

    rng = np.random.default_rng(0)

    def timed(n: int) -> float:
        genes = ["".join(rng.choice(list("ACGT"), n)) for _ in range(2)]
        align_pairs(genes, [(1, 0)], 3, 2)  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            align_pairs(genes, [(1, 0)], 3, 2)
            best = min(best, time.time() - t0)
        return best

    t_small = timed(small_len)
    t_big = timed(sample_len)
    if t_big <= t_small:
        # Timing noise inverted the two samples — one retry with more reps;
        # a silently exploded gcups would degrade every schedule
        # downstream, so a still-inverted calibration returns None and the
        # caller falls back to the analytic model.
        if reps < 8:
            return calibrate(
                sample_len, small_len, reps=reps * 4, use_cache=False
            )
        return None
    d_cells = sample_len * sample_len - small_len * small_len
    gcups = d_cells / (t_big - t_small) / 1e9
    fixed_us = max(t_small * 1e6 - small_len * small_len / gcups / 1e3, 0.0)
    model = CalibratedCost(gcups=gcups, fixed_us=fixed_us)
    save_calibration(device_kind, sample_len, small_len, model)
    return model
