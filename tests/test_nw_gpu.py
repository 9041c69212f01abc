"""The big-pair device path (``ops/nw_gpu``) and what surrounds it.

The CUDA kernels have no interpret mode. On the CPU their contract is
checked through the plain-JAX twin, which the card's run compares them with
byte for byte (``chip_smoke.py``); the tests marked ``gpu`` run the CUDA
kernels themselves and skip without a card (``tests/conftest.py``).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from msa_tpu.ops import nw_gpu
from msa_tpu.ops.reference import nw_align_numpy, nw_dirs, nw_dp_matrix
from tests.test_oracle import CASES

REPO = pathlib.Path(__file__).resolve().parent.parent
# CPU devices report no memory, so the plans here get a fixed budget.
PLAIN = nw_gpu.PlainKernels(budget=1 << 30)

TWIN_CASES = [c for c in CASES if c[0] and c[1]] + [
    ("A", "ACGTTGCA" * 5, 3, 2),  # 1 x n
    ("GATTACAGATTACA" * 6, "C", 3, 2),  # n x 1
    ("ACGT" * 75, "GATTACA", 3, 2),  # skewed, long x
    ("GA", "ACGTTCGA" * 40, 5, 1),  # skewed, long y
    ("ABAB" * 30, "BABA" * 25, 3, 2),  # tie-heavy repeats
    ("AAAA" * 20, "AAA" * 17, 3, 0),  # free gaps: every move ties
]


def _cpu():
    return jax.devices()[0]


def unpack(packed: np.ndarray, n: int) -> np.ndarray:
    """(m, row_bytes(n)) uint8 -> (m, n) codes, read as uint32 words.

    Reading the bytes as little-endian uint32 words, with cell j-1 at bits
    2*((j-1) % 16) of word (j-1) // 16, is the layout the CUDA kernels write.
    """
    words = np.ascontiguousarray(packed).view("<u4")
    cols = np.arange(n)
    return ((words[:, cols // 16] >> (2 * (cols % 16))) & 3).astype(np.int8)


@pytest.mark.parametrize("x,y,pxy,pgap", TWIN_CASES)
def test_plain_twin_matches_oracle(x, y, pxy, pgap):
    got = nw_gpu.align_pairs(
        [x, y], [(0, 1)], pxy, pgap, kernels=PLAIN, device=_cpu()
    )
    assert got == [nw_align_numpy(x, y, pxy, pgap)]


def test_plain_twin_group_matches_oracle():
    """One group of many pairs of mixed shapes, in canonical orientation."""
    rng = np.random.default_rng(11)
    genes = [
        "".join(rng.choice(list("ACGT"), n)) for n in (1, 7, 40, 95, 130, 33)
    ]
    pairs = [(i, j) for i in range(len(genes)) for j in range(i)]
    got = nw_gpu.align_pairs(genes, pairs, 3, 2, kernels=PLAIN, device=_cpu())
    assert got == [nw_align_numpy(genes[i], genes[j], 3, 2) for i, j in pairs]


@pytest.mark.parametrize("m,n", [(1, 1), (37, 16), (50, 83)])
def test_move_packing_roundtrip(m, n):
    """Every packed cell, not only the walked path, equals the oracle's."""
    rng = np.random.default_rng(m * 1000 + n)
    x = "".join(rng.choice(list("ACG"), m))
    y = "".join(rng.choice(list("ACG"), n))
    g = PLAIN.prepare([x, y], [(0, 1)], _cpu())
    scores, moves = PLAIN.fill(g, 3, 2)
    packed = np.asarray(PLAIN.pair_moves(g, moves, 0))
    assert packed.shape == (m, nw_gpu.row_bytes(n))
    want = nw_dirs(nw_dp_matrix(x, y, 3, 2), x, y, 3, 2)
    np.testing.assert_array_equal(unpack(packed, n), want)
    # Bits past column n are zero.
    cols = np.arange(nw_gpu.row_bytes(n) * 4)
    words = packed.view("<u4")
    pad = (words[:, cols // 16] >> (2 * (cols % 16))) & 3
    assert not pad[:, n:].any()
    assert int(np.asarray(scores)[0]) == nw_align_numpy(x, y, 3, 2)[0]


@pytest.mark.parametrize("budget", [3_000, 20_000, 1 << 30])
def test_plan_groups_within_budget(budget):
    dims = [(m, n) for m in (5, 30, 90) for n in (7, 64)]
    groups = nw_gpu.plan_groups(dims, budget, nw_gpu.CUDA.group_bytes)
    flat = sorted(p for g in groups for p in g)
    assert flat == list(range(len(dims)))  # every pair exactly once
    for g in groups:
        assert nw_gpu.CUDA.group_bytes([dims[p] for p in g]) <= budget
    if budget == 1 << 30:
        assert len(groups) == 1


def test_plan_groups_pair_over_budget_raises():
    with pytest.raises(MemoryError):
        nw_gpu.plan_groups([(10, 10), (3000, 3000)], 10_000,
                           nw_gpu.CUDA.group_bytes)


def test_group_refused_by_allocator_is_split():
    """A group the allocator refuses is halved until it fits."""
    calls = []

    class Fragmented(nw_gpu.PlainKernels):
        def fill_walk(self, g, pxy, pgap):
            calls.append(len(g.pairs))
            if len(g.pairs) > 2:
                raise jax.errors.JaxRuntimeError(
                    "RESOURCE_EXHAUSTED: Out of memory while trying to"
                    " allocate"
                )
            return super().fill_walk(g, pxy, pgap)

    rng = np.random.default_rng(5)
    genes = ["".join(rng.choice(list("ACGT"), n)) for n in (20, 31, 9, 44)]
    pairs = [(i, j) for i in range(4) for j in range(i)]
    got = nw_gpu.align_pairs(
        genes, pairs, 3, 2, kernels=Fragmented(budget=1 << 30), device=_cpu()
    )
    assert got == [nw_align_numpy(genes[i], genes[j], 3, 2) for i, j in pairs]
    assert calls == [6, 3, 1, 2, 3, 1, 2]


def test_device_without_memory_report_raises():
    class NoReport:
        def memory_stats(self):
            return None

    with pytest.raises(RuntimeError, match="no memory limit"):
        nw_gpu.CudaKernels().plan([(100, 100)], NoReport())
    # The CPU backend is such a device.
    with pytest.raises(RuntimeError, match="no memory limit"):
        nw_gpu.device_budget(_cpu())


def test_cuda_group_tables():
    """Host tables of a CUDA call: offsets, strips and ticket order."""
    genes = ["A" * 600, "C" * 40, "G" * 300]
    pairs = [(1, 0), (2, 0), (2, 1)]
    g = nw_gpu.cuda_group(genes, pairs)
    dims = [(40, 600), (300, 600), (300, 40)]
    assert [tuple(r[2:4]) for r in g.table] == dims
    strips = [-(-m // nw_gpu.STRIP_ROWS) for m, _ in dims]
    assert list(g.table[:, 4]) == [0, 600, 1200]  # row buffer offsets
    assert list(g.table[:, 5]) == [0, strips[0], strips[0] + strips[1]]
    assert g.move_sizes == tuple(m * nw_gpu.row_bytes(n) for m, n in dims)
    assert g.aux_len == 2 * 3 + sum(n for _, n in dims) + sum(strips) + 1
    # Every (pair, strip) once; each pair's strips in order.
    tk = [tuple(t) for t in g.tickets]
    assert sorted(tk) == [(p, k) for p in range(3) for k in range(strips[p])]
    for p in range(3):
        assert [k for q, k in tk if q == p] == list(range(strips[p]))
    assert g.max_len == 900
    seq = g.seqs.tobytes()
    for p, (i, j) in enumerate(pairs):
        x0, y0, m, n = g.table[p, :4]
        assert seq[x0:x0 + m] == genes[i].encode()
        assert seq[y0:y0 + n] == genes[j].encode()


@pytest.mark.parametrize("n_devices", [1, 4])
def test_kway_device_path_plain_twin(monkeypatch, data_dir, n_devices):
    """KWayAligner's device routing, LPT split and decode, golden-gated."""
    from msa_tpu.config import DEFAULT
    from msa_tpu.models.kway import KWayAligner
    from msa_tpu.utils.goldens import MSEQ1_HASH, MSEQ1_PENALTIES
    from msa_tpu.utils.msaio import parse_file

    monkeypatch.setattr(DEFAULT, "small_threshold", 0)
    monkeypatch.setattr(DEFAULT, "local_devices", n_devices)
    seen = []
    real = nw_gpu.align_pairs

    def spy(genes, pairs, *a, **kw):
        seen.append((kw["device"], len(pairs)))
        return real(genes, pairs, *a, **kw)

    monkeypatch.setattr(nw_gpu, "align_pairs", spy)
    problem = parse_file(str(data_dir / "mseq1.dat"))
    r = KWayAligner(
        problem.pxy, problem.pgap, backend="device", kernels=PLAIN
    ).align_all(problem.genes)
    assert r.chain_hash == MSEQ1_HASH
    assert r.penalties == MSEQ1_PENALTIES
    assert len({d for d, _ in seen}) == n_devices
    assert sum(k for _, k in seen) == 36


def test_cli_device_backend_refused_on_cpu(data_dir, capsys):
    from msa_tpu.cli import main

    rc = main(["--backend", "device", "--input", str(data_dir / "mseq.dat")])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "needs a CUDA GPU" in out.err


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_refuse_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_compile_cache_default(monkeypatch):
    from msa_tpu.utils import jaxenv

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    assert jaxenv.setup_jax_env() == jaxenv.DEFAULT_CACHE_DIR
    assert os.path.dirname(jaxenv.DEFAULT_CACHE_DIR) == str(REPO)
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == jaxenv.DEFAULT_CACHE_DIR


def test_compile_cache_env_kept(monkeypatch, tmp_path):
    from msa_tpu.utils import jaxenv

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    assert jaxenv.setup_jax_env() == str(tmp_path)


# ---------------------------------------------------------------- on a card


@pytest.mark.gpu
def test_cuda_matches_plain_twin(gpu_device):
    rng = np.random.default_rng(0)
    genes = [
        "".join(rng.choice(list("ACGT"), n))
        for n in (1, 31, 33, 255, 256, 257, 600, 1000)
    ] + ["ABAB" * 80, "BABA" * 70]
    pairs = [(i, j) for i in range(len(genes)) for j in range(i)]
    for pxy, pgap in ((3, 2), (5, 1)):
        out = {}
        for k in (nw_gpu.CUDA, nw_gpu.PLAIN):
            g = k.prepare(genes, pairs, gpu_device)
            scores, moves = k.fill(g, pxy, pgap)
            streams, counts = k.walk(g, moves)
            out[k.name] = (
                np.asarray(scores),
                [np.asarray(k.pair_moves(g, moves, p)) for p in range(len(pairs))],
                np.asarray(counts),
                np.asarray(streams),
            )
        c, p = out["cuda"], out["plain"]
        np.testing.assert_array_equal(c[0], p[0])
        for a, b in zip(c[1], p[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c[2], p[2])
        for q in range(len(pairs)):
            np.testing.assert_array_equal(c[3][q, : c[2][q]], p[3][q, : p[2][q]])


@pytest.mark.gpu
def test_cuda_kway_golden(gpu_device, monkeypatch, data_dir):
    from msa_tpu.config import DEFAULT
    from msa_tpu.models.kway import align_kway
    from msa_tpu.utils.goldens import MSEQ1_HASH
    from msa_tpu.utils.msaio import parse_file

    monkeypatch.setattr(DEFAULT, "small_threshold", 0)
    r = align_kway(parse_file(str(data_dir / "mseq1.dat")), backend="device")
    assert r.chain_hash == MSEQ1_HASH


def test_goldens_module_matches_recorded_outputs(data_dir):
    from msa_tpu.utils import goldens

    assert json.loads(
        (data_dir / "host_goldens.jsonl").read_text().splitlines()[0]
    )["chain_hash"] == goldens.host_golden("xulin_adversarial.dat")[0]
    assert goldens.check("mseq.dat", goldens.MSEQ_HASH, goldens.MSEQ_PENALTIES)
    assert not goldens.check("mseq.dat", goldens.MSEQ_HASH, [5, 4, 8])
