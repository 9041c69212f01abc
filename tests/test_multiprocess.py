"""Multi-process integration: the distributed engine end-to-end on CPU.

Launches REAL separate processes through the CLI with
``jax.distributed.initialize`` + gloo CPU collectives, exercising the full
multi-host path the reference ran over MPI ranks
(``submit/xuliny-seqalkway.cpp:232-417``): per-process LPT shard,
``process_allgather`` merge, identical hash-chain fold, process-0-only
stdout. The golden mseq1 output gates correctness.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

MSEQ1_HASH = (
    "4d676f40ea4c1e6b79f546d8c87214c5c7c18e3e55ed0844edfdc73b82bbc9f2"
    "1b0f4a2eab30b0ddb6b499b623e23e5dd598ef7a5c7175ecfc0235ac0858c20a"
)
MSEQ1_PENALTIES = (
    "5 4 9 12 14 11 11 10 11 10 20 22 16 8 15 36 38 32 24 28 22 31 30 27 "
    "22 20 22 20 20 22 16 8 15 0 22 22 "
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc: int, extra_args=None, tmp_path=None, backend="numpy",
            extra_env=None):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # no virtual-device forcing in subprocesses
    env.update(extra_env or {})
    procs = []
    for pid in range(nproc):
        cmd = [
            sys.executable, "-m", "msa_tpu.cli",
            "--distributed",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nproc),
            "--process-id", str(pid),
            "--backend", backend,
            "--platform", "cpu",
            "--input", str(REPO / "data" / "mseq1.dat"),
        ] + (extra_args or [])
        procs.append(
            subprocess.Popen(
                cmd,
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc failed:\n{err[-2000:]}"
        outs.append(out)
    return outs


def test_two_process_golden_mseq1():
    outs = _launch(2)
    # Only process 0 prints the result (gloo emits a stdout banner line;
    # the contract block is the trailing Time/hash/penalties triple).
    lines = [l for l in outs[0].splitlines() if not l.startswith("[Gloo]")]
    assert lines[0].startswith("Time: ") and lines[0].endswith(" us")
    assert lines[1] == MSEQ1_HASH
    assert lines[2] == MSEQ1_PENALTIES.rstrip("\n")  # trailing space kept
    assert MSEQ1_HASH not in outs[1]


def test_two_process_checkpoint_journals(tmp_path):
    ck = str(tmp_path / "journal-{proc}.jsonl")
    outs = _launch(2, extra_args=["--checkpoint", ck])
    assert MSEQ1_HASH in outs[0]
    # Per-process journals exist and partition the 36 tasks disjointly.
    import json

    seen = {}
    for pid in (0, 1):
        path = tmp_path / f"journal-{pid}.jsonl"
        assert path.exists(), "per-process journal missing"
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            assert rec["task_id"] not in seen, "task duplicated across procs"
            seen[rec["task_id"]] = pid
    assert len(seen) == 36
