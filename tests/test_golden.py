"""Golden conformance tests against the reference outputs.

Expected values are the reference's recorded cluster outputs
(``testing15/mseq-12node-16-cpt-1-npn-snowy.out``, ``…/mseq1-…out``,
``testing15/sample.txt``; also ``docs/Project2B.pdf`` p.7) — see BASELINE.md.
"""

import pytest

from msa_tpu.models.kway import align_kway
from msa_tpu.utils.goldens import (  # noqa: F401  (test_parallel imports)
    MSEQ1_HASH,
    MSEQ1_PENALTIES,
    MSEQ_HASH,
    MSEQ_PENALTIES,
)
from msa_tpu.utils.msaio import parse_file


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_mseq_golden(data_dir, backend):
    problem = parse_file(str(data_dir / "mseq.dat"))
    result = align_kway(problem, backend=backend)
    assert result.penalties == MSEQ_PENALTIES
    assert result.chain_hash == MSEQ_HASH


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_mseq1_golden(data_dir, backend):
    problem = parse_file(str(data_dir / "mseq1.dat"))
    result = align_kway(problem, backend=backend)
    assert result.penalties == MSEQ1_PENALTIES
    assert result.chain_hash == MSEQ1_HASH


def test_mseq_alignments(data_dir):
    """The individual alignments recorded during the survey (SURVEY.md §4.6)."""
    problem = parse_file(str(data_dir / "mseq.dat"))
    result = align_kway(problem, backend="numpy", keep_alignments=True)
    pairs = [(r.align1, r.align2) for r in result.pair_results]
    assert pairs[0] == ("A_GGCA", "AGGGCT")
    assert pairs[1] == ("AAAGGGCT", "__AGGGCT")
    assert pairs[2] == ("AAAGGGCT", "__A_GGCA")


def test_cli_output_contract(data_dir, capsys):
    from msa_tpu.cli import main

    rc = main(["--backend", "numpy", "--input", str(data_dir / "mseq.dat")])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.split("\n")
    assert lines[0].startswith("Time: ") and lines[0].endswith(" us")
    assert lines[1].startswith("602d0f604e8fb908")
    assert lines[2] == "5 4 9 "
    assert out.endswith("\n")
