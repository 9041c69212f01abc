"""Scheduler + mesh-sharded engine tests (8 virtual CPU devices)."""

import jax
import numpy as np
import pytest

from msa_tpu.parallel.schedule import lpt_schedule, pair_costs, schedule_for
from msa_tpu.utils.tasks import pair_task_list


def test_lpt_deterministic_and_complete():
    genes = ["A" * 100, "C" * 50, "G" * 200, "T" * 10, "AC" * 40]
    s1 = schedule_for(genes, 4)
    s2 = schedule_for(genes, 4)
    assert s1 == s2
    all_ids = sorted(t.task_id for shard in s1 for t in shard)
    assert all_ids == [t.task_id for t in pair_task_list(len(genes))]


def test_lpt_balances_load():
    genes = ["A" * 1000] * 6  # 15 equal pairs
    shards = schedule_for(genes, 5)
    loads = [sum(1 for _ in s) for s in shards]
    assert max(loads) - min(loads) <= 1


def test_lpt_heaviest_first():
    genes = ["A" * 1000, "C" * 1000, "G" * 10, "T" * 10]
    costs = pair_costs(genes)
    shards = lpt_schedule(costs, 2)
    # the single million-cell pair must sit alone-ish on one shard
    big_shard = [s for s in shards if any(t.task_id == 0 for t in s)][0]
    big_load = sum(
        len(genes[t.i]) * len(genes[t.j]) for t in big_shard
    )
    other = [s for s in shards if s is not big_shard][0]
    other_load = sum(len(genes[t.i]) * len(genes[t.j]) for t in other)
    assert big_load >= other_load


def test_sharded_pair_scores_8_devices():
    from msa_tpu.ops.reference import nw_score_numpy
    from msa_tpu.parallel.engine import sharded_pair_scores
    from msa_tpu.parallel.mesh import get_mesh
    from msa_tpu.utils.tasks import pair_task_list

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    genes = ("AGGGCT", "AGGCA", "AAAGGGCT", "ACGTACGT", "TTTT", "GATTACA")
    mesh = get_mesh()
    scores = sharded_pair_scores(genes, 3, 2, mesh=mesh)
    want = [
        nw_score_numpy(genes[t.i], genes[t.j], 3, 2)
        for t in pair_task_list(len(genes))
    ]
    np.testing.assert_array_equal(scores, np.array(want))


def test_align_kway_sharded_single_process(data_dir):
    from msa_tpu.parallel.engine import align_kway_sharded
    from msa_tpu.utils.msaio import parse_file
    from tests.test_golden import MSEQ1_HASH, MSEQ1_PENALTIES

    problem = parse_file(str(data_dir / "mseq1.dat"))
    result = align_kway_sharded(problem, backend="numpy")
    assert result.penalties == MSEQ1_PENALTIES
    assert result.chain_hash == MSEQ1_HASH


def test_wavefront_sharded_scores_8_devices():
    from msa_tpu.ops.nw_sp import nw_score_wavefront_sharded
    from msa_tpu.ops.reference import nw_score_numpy
    from msa_tpu.parallel.mesh import get_mesh

    mesh = get_mesh()
    import random

    rng = random.Random(42)
    for _ in range(4):
        m, n = rng.randint(3, 120), rng.randint(3, 120)
        x = "".join(rng.choice("ACGT") for _ in range(m))
        y = "".join(rng.choice("ACGT") for _ in range(n))
        got = nw_score_wavefront_sharded(x, y, 3, 2, mesh)
        want = nw_score_numpy(x, y, 3, 2)
        assert got == want, (m, n, got, want)


def test_block_schedule_matches_reference_layout():
    # parallel1.cpp:185-201 semantics: floor split, remainder on the tail.
    from msa_tpu.parallel.schedule import block_schedule
    from msa_tpu.utils.tasks import pair_task_list

    tasks = pair_task_list(6)  # 15 pairs
    shards = block_schedule(tasks, 4)  # tpp = 3
    assert [len(s) for s in shards] == [3, 3, 3, 6]
    ids = [t.task_id for s in shards for t in s]
    assert ids == list(range(15))


def test_schedule_policy_dispatch():
    genes = ["ACGT" * (i + 1) for i in range(5)]
    lpt = schedule_for(genes, 3, policy="lpt")
    blk = schedule_for(genes, 3, policy="block")
    all_lpt = sorted(t.task_id for s in lpt for t in s)
    all_blk = sorted(t.task_id for s in blk for t in s)
    assert all_lpt == all_blk == list(range(10))


def test_wavefront_sharded_alignment_8_devices():
    """Sharded fill + host windowed-recompute traceback, exact vs oracle."""
    from msa_tpu.ops.nw_sp import nw_align_wavefront_sharded
    from msa_tpu.ops.reference import nw_align_numpy
    from msa_tpu.parallel.mesh import get_mesh

    mesh = get_mesh()
    rng = np.random.default_rng(3)
    for (m, n, pxy, pgap) in [(300, 280, 3, 2), (1100, 850, 5, 1)]:
        x = "".join(rng.choice(list("ACGT"), m))
        y = "".join(rng.choice(list("ACGT"), n))
        got = nw_align_wavefront_sharded(
            x, y, pxy, pgap, mesh, ckpt_every=128
        )
        assert got == nw_align_numpy(x, y, pxy, pgap)


def test_wavefront_sharded_alignment_10k():
    """>=10k-char pair: every device's lane chunk and halo actually carry
    state; the full alignment (not just the score) survives sharding."""
    from msa_tpu.ops.nw_sp import nw_align_wavefront_sharded
    from msa_tpu.ops.reference import nw_align_numpy
    from msa_tpu.parallel.mesh import get_mesh

    rng = np.random.default_rng(9)
    x = "".join(rng.choice(list("ACGT"), 11000))
    y = "".join(rng.choice(list("ACGT"), 10500))
    got = nw_align_wavefront_sharded(x, y, 3, 2, get_mesh(8))
    assert got == nw_align_numpy(x, y, 3, 2)


def test_calibrated_schedule_policy():
    """S5 parity: LPT over a measured wall-clock cost model (testing11)."""
    from msa_tpu.parallel.costmodel import CalibratedCost
    from msa_tpu.parallel.schedule import pair_costs_calibrated

    genes = ["A" * 2000, "C" * 2000, "G" * 10, "T" * 10, "AC" * 5]
    model = CalibratedCost(gcups=50.0, fixed_us=100_000.0)
    # Deterministic and complete.
    s1 = schedule_for(genes, 3, policy="calibrated", cost_model=model)
    s2 = schedule_for(genes, 3, policy="calibrated", cost_model=model)
    assert s1 == s2
    all_ids = sorted(t.task_id for shard in s1 for t in shard)
    assert all_ids == [t.task_id for t in pair_task_list(len(genes))]
    # The fixed term makes tiny pairs non-free: with 10 pairs and a fixed
    # cost dominating 8 of them, no shard may hoard all the tiny pairs while
    # another idles (pure m*n LPT would put ALL 8 tiny pairs on one shard).
    loads = [
        sum(model.cost_us(len(genes[t.i]), len(genes[t.j])) for t in s)
        for s in s1
    ]
    assert max(loads) <= 2 * min(loads) + model.fixed_us
    costs = dict(
        (t.task_id, c) for t, c in pair_costs_calibrated(genes, model)
    )
    assert costs[0] == model.cost_us(2000, 2000)


def test_calibration_cache_roundtrip(tmp_path, monkeypatch):
    """Calibrations persist keyed by device kind + kernel version."""
    from msa_tpu.parallel.costmodel import (
        CalibratedCost,
        load_cached_calibration,
        save_calibration,
    )

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert load_cached_calibration("NVIDIA H100 80GB HBM3", 20000, 2048) is None
    model = CalibratedCost(gcups=142.5, fixed_us=31250.0)
    save_calibration("NVIDIA H100 80GB HBM3", 20000, 2048, model)
    got = load_cached_calibration("NVIDIA H100 80GB HBM3", 20000, 2048)
    assert got == model
    # Different device kind / sample geometry: distinct keys.
    assert load_cached_calibration("NVIDIA A100-SXM4-80GB", 20000, 2048) is None
    assert load_cached_calibration("NVIDIA H100 80GB HBM3", 20000, 4096) is None


def test_band_striped_alignment_8_devices():
    """Band-striped cross-device fill: pipelined stripe sweep with chunked
    boundary-row streaming (one ppermute per K columns, not per diagonal)
    stays byte-exact vs the oracle, including walks crossing stripes."""
    from msa_tpu.ops.nw_striped import nw_align_band_striped
    from msa_tpu.ops.reference import nw_align_numpy
    from msa_tpu.parallel.mesh import get_mesh

    mesh = get_mesh(8)
    rng = np.random.default_rng(17)
    for (m, n, pxy, pgap, kc) in [
        (301, 287, 3, 2, 64),
        (850, 1100, 5, 1, 128),  # n > m: walk leaves by the left border
        (2100, 1900, 3, 2, 256),
    ]:
        x = "".join(rng.choice(list("ACGT"), m))
        y = "".join(rng.choice(list("ACGT"), n))
        got = nw_align_band_striped(x, y, pxy, pgap, mesh, kchunk=kc)
        assert got == nw_align_numpy(x, y, pxy, pgap), (m, n)


def test_single_pair_striped_engine(monkeypatch):
    """single_pair_striped=1: a lone giant pair routes through the
    band-striped cross-device fill inside the PRODUCTION k-way engine,
    with the hash chain identical to the host-oracle run."""
    from msa_tpu.config import DEFAULT
    from msa_tpu.models.kway import align_kway
    from msa_tpu.utils.msaio import Problem

    rng = np.random.default_rng(29)
    x = "".join(rng.choice(list("ACGT"), 2300))
    y = "".join(rng.choice(list("ACGT"), 2100))
    problem = Problem(pxy=3, pgap=2, genes=(x, y))

    monkeypatch.setattr(DEFAULT, "single_pair_striped", 1)
    monkeypatch.setattr(DEFAULT, "small_threshold", 1 << 16)
    called = {"n": 0}
    import msa_tpu.ops.nw_striped as striped

    real = striped.nw_align_band_striped

    def counting(*a, **kw):
        called["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(striped, "nw_align_band_striped", counting)
    got = align_kway(problem, backend="auto")
    want = align_kway(problem, backend="numpy")
    assert got.chain_hash == want.chain_hash
    assert got.penalties == want.penalties
    assert called["n"] == 1, "striped path was not taken"
