"""Unit tests for I/O contract, hashing, tasks, config, timing."""

import io

import pytest

from msa_tpu.config import EngineConfig
from msa_tpu.utils.alignment import finish_alignment, moves_to_alignment
from msa_tpu.utils.hashing import chain_hashes, pair_hash, sha512_hex
from msa_tpu.utils.msaio import Problem, format_output, parse_input
from msa_tpu.utils.tasks import num_pairs, pair_task_list, task_id
from msa_tpu.utils.timing import StageTimer, gcups, timestamp_us


def test_parse_input_whitespace_forms():
    p1 = parse_input("3 2 3\nACGT GGG\nTTTT\n")
    p2 = parse_input("3\n2\n3 ACGT\nGGG TTTT")
    assert p1 == p2 == Problem(3, 2, ("ACGT", "GGG", "TTTT"))
    assert p1.num_pairs == 3


def test_parse_input_errors():
    with pytest.raises(ValueError):
        parse_input("3 2")
    with pytest.raises(ValueError):
        parse_input("3 2 5 ACGT GG")


def test_format_output_contract():
    out = format_output(12345, "ab" * 64, [5, 4, 9])
    lines = out.split("\n")
    assert lines[0] == "Time: 12345 us"
    assert lines[1] == "ab" * 64
    assert lines[2] == "5 4 9 "  # trailing space, as the reference prints
    assert out.endswith("\n")


def test_task_id_enumeration():
    tasks = pair_task_list(5)
    assert len(tasks) == num_pairs(5) == 10
    for t in tasks:
        assert t.task_id == task_id(t.i, t.j)
        assert t.i > t.j
    assert [t.task_id for t in tasks] == list(range(10))


def test_hash_chain_algebra():
    h1 = sha512_hex("A_GGCA")
    h2 = sha512_hex("AGGGCT")
    ph = pair_hash("A_GGCA", "AGGGCT")
    assert ph == sha512_hex(h1 + h2)
    assert chain_hashes([ph]) == sha512_hex("" + ph)
    assert len(ph) == 128 and ph == ph.lower()


def test_moves_to_alignment_validation():
    with pytest.raises(ValueError):
        # Walk that stops before reaching a border.
        moves_to_alignment("ACG", "ACG", [0])
    with pytest.raises(ValueError):
        finish_alignment("A", "C", 0, 0, "AB", "C")  # length mismatch


def test_engine_config_env(monkeypatch):
    monkeypatch.setenv("MSA_TPU_SMALL_THRESHOLD", "4096")
    monkeypatch.setenv("MSA_TPU_BACKEND", "numpy")
    cfg = EngineConfig.from_env()
    assert cfg.small_threshold == 4096
    assert cfg.backend == "numpy"


def test_stage_timer_and_gcups():
    t = StageTimer()
    with t.stage("fill"):
        pass
    with t.stage("fill"):
        pass
    assert t.counts["fill"] == 2
    assert "fill" in t.report()
    assert gcups(2_000_000_000, 2.0) == 1.0
    assert timestamp_us() > 0
