"""Warm small-problem latency floor on the device.

The reference's latency floor on trivial inputs was 78.7 ms for mseq.dat
on a 12-node cluster (``testing15/mseq-12node-16-cpt-1-npn-snowy.out:13``)
— startup/broadcast dominated (SURVEY.md §3.5). Here the cold run is
compile-dominated; this script runs each small dataset several times in ONE
process (the deployment shape: a resident service aligning many problems)
and records cold vs warm, hash-gated against the reference goldens.

Writes artifacts/warm_latency.json.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from msa_tpu.utils import jaxenv  # noqa: F401

GOLDEN = {
    "mseq.dat": "602d0f604e8fb908",
    "mseq1.dat": "4d676f40ea4c1e6b",
}


def main():
    from msa_tpu.models.kway import align_kway
    from msa_tpu.utils.msaio import parse_file

    out = {}
    ok = True
    for name, prefix in GOLDEN.items():
        problem = parse_file(os.path.join(REPO, "data", name))
        t0 = time.time()
        r1 = align_kway(problem, backend="device")
        cold = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.time()
            r2 = align_kway(problem, backend="device")
            times.append(time.time() - t0)
            if r2.chain_hash != r1.chain_hash:
                ok = False
        warm = min(times)
        match = prefix is None or r1.chain_hash.startswith(prefix)
        ok = ok and match
        out[name] = {
            "cold_s": round(cold, 3),
            "warm_s": round(warm, 4),
            "warm_reps_s": [round(t, 4) for t in times],
            "hash_ok": bool(match),
        }
        print(
            f"{name}: cold {cold:.3f}s warm {warm:.4f}s "
            f"{'OK' if match else 'HASH MISMATCH'}",
            flush=True,
        )
    out["reference_floor_s"] = 0.0787  # 12-node cluster, mseq.dat
    os.makedirs(os.path.join(REPO, "artifacts"), exist_ok=True)
    with open(os.path.join(REPO, "artifacts", "warm_latency.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
