"""Golden outputs the bundled datasets must reproduce byte for byte.

Sources: the reference's recorded cluster outputs (BASELINE.md) and, for
the two datasets the reference never ran, the host oracle's recorded
output (``data/host_goldens.jsonl``, trusted only for the dataset file
whose SHA-256 it names).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "data")

# testing15/12node-16-cpt-1-npn-snowy.out:2-3
BIG13_HASH = (
    "c0befee8737ac74a1ece5abae5cca722c2eaf2bf028aaca8f3f6607204b7e68e"
    "a0707a881d5512a723439ab67007e5301a9c126272a3ff2ad96923b0dcf27dab"
)
BIG13_PENALTIES = [int(v) for v in """31202 48016 25007 56880 53193 37279
52116 30000 32754 48092 60756 61018 60977 48923 33238 66240 50320 59270 40544
49432 35042 78083 68543 50000 49163 48080 20000 44441 86911 70000 67514 57881
40000 46264 26560 27675 95621 87344 76149 60000 62871 53120 38797 41672 27581
104197 94673 80000 75191 65682 56240 51869 42800 40810 29031 112962 100000
90000 83981 74245 64669 54941 45332 35586 33228 33143 120000 110000 102209
92694 80000 75951 60000 57329 40000 38890 30859 15323""".split()]
# testing15/mseq-12node-16-cpt-1-npn-snowy.out:14-15
MSEQ_HASH = (
    "602d0f604e8fb908195d53e681094f7d063c4168a33a18f32b4ca3d29f27073a"
    "486dca2ab98aab9eb47f5c407b5c59b8e6c0fa8ef4d07d131b8d6a66a37a065f"
)
MSEQ_PENALTIES = [5, 4, 9]
# testing15/mseq1-12node-16-cpt-1-npn-snowy.out:14-15
MSEQ1_HASH = (
    "4d676f40ea4c1e6b79f546d8c87214c5c7c18e3e55ed0844edfdc73b82bbc9f2"
    "1b0f4a2eab30b0ddb6b499b623e23e5dd598ef7a5c7175ecfc0235ac0858c20a"
)
MSEQ1_PENALTIES = [
    5, 4, 9, 12, 14, 11, 11, 10, 11, 10, 20, 22, 16, 8, 15, 36, 38, 32,
    24, 28, 22, 31, 30, 27, 22, 20, 22, 20, 20, 22, 16, 8, 15, 0, 22, 22,
]
# testing15/big13-2-12node-…out:2 records only this prefix here; the
# dataset permutes big13's genes, so its penalties are big13's, permuted.
BIG13_2_PREFIX = "7af9b197a65577f9"


def host_golden(name: str) -> Optional[Tuple[str, List[int]]]:
    """(chain hash, penalties) recorded for ``data/<name>``, if any."""
    path = os.path.join(DATA, name)
    with open(os.path.join(DATA, "host_goldens.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["dataset"] != f"data/{name}":
                continue
            with open(path, "rb") as df:
                if hashlib.sha256(df.read()).hexdigest() != rec["dataset_sha256"]:
                    return None
            return rec["chain_hash"], rec["penalties"]
    return None


def check(name: str, chain_hash: str, penalties: List[int]) -> bool:
    """Whether a result for ``data/<name>`` matches its golden exactly."""
    if name == "mseq-big13-example.txt":
        return chain_hash == BIG13_HASH and penalties == BIG13_PENALTIES
    if name == "mseq-big13-example2.txt":
        return chain_hash.startswith(BIG13_2_PREFIX) and sorted(
            penalties
        ) == sorted(BIG13_PENALTIES)
    if name == "mseq.dat":
        return chain_hash == MSEQ_HASH and penalties == MSEQ_PENALTIES
    if name == "mseq1.dat":
        return chain_hash == MSEQ1_HASH and penalties == MSEQ1_PENALTIES
    rec = host_golden(name)
    if rec is None:
        raise KeyError(f"no golden recorded for {name}")
    return (chain_hash, penalties) == (rec[0], list(rec[1]))
