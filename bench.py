"""Benchmark: end-to-end mseq-big13 all-pairs alignment on one GPU.

Prints the device and the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "cold_s", "warm_s", "device"}.
Refuses (exit 1, no JSON) where JAX finds no GPU.

Workload: the reference's headline benchmark — k=13, 78 pairwise NW DPs,
2.785e11 cells (BASELINE.md). Baseline: the reference's best 12-node/192-core
cluster result, 15 672 995 us => ~17.8 GCUPS aggregate
(testing15/12node-16-cpt-1-npn-snowy.out). Every run, cold and warm, is
gated on the full golden chain hash and all 78 penalties.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from msa_tpu.utils import jaxenv  # noqa: E402,F401  (compile cache setup)

BASELINE_GCUPS = 17.77  # 2.785e11 cells / 15.672995 s / 1e9
REPS = 5


def workload_cells(genes):
    total = 0
    for i in range(1, len(genes)):
        for j in range(i):
            total += len(genes[i]) * len(genes[j])
    return total


def main():
    from msa_tpu.models.kway import align_kway
    from msa_tpu.utils import device, goldens
    from msa_tpu.utils.msaio import parse_file

    dev = device.describe()
    print("device:", json.dumps(dev), flush=True)
    if dev["platform"] != "gpu":
        print("bench.py needs a CUDA GPU; no result", file=sys.stderr)
        return 1
    print("nvidia-smi:", device.nvidia_smi(), flush=True)

    problem = parse_file(os.path.join(goldens.DATA, "mseq-big13-example.txt"))
    cells = workload_cells(problem.genes)

    def run():
        t0 = time.perf_counter()
        result = align_kway(problem, backend="device")
        dt = time.perf_counter() - t0
        if not goldens.check(
            "mseq-big13-example.txt", result.chain_hash, result.penalties
        ):
            raise SystemExit("hash/penalties mismatch vs golden; no result")
        return dt

    # The first run builds the CUDA library (if stale) and compiles.
    cold = run()
    times = [run() for _ in range(REPS)]
    gcups = cells / min(times) / 1e9
    print(
        json.dumps(
            {
                "metric": "big13_e2e_gcups",
                "value": gcups,
                "unit": "GCUPS",
                "vs_baseline": gcups / BASELINE_GCUPS,
                "cold_s": cold,
                "warm_s": times,
                "device": dev,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
