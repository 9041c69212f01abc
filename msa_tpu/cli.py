"""CLI with the reference's exact I/O contract.

Usage (drop-in for ``mpirun <binary> < dataset``)::

    python -m msa_tpu.cli < mseq.dat
    python -m msa_tpu.cli --backend numpy --input data/mseq1.dat

Reads pxy, pgap, k and k sequences; prints ``Time: <us> us``, the SHA-512
chain hash, and the space-separated penalties, byte-identical to the
reference driver (``seqalign-mpi-skeleton.cpp:61-69``).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="msa_tpu", description=__doc__)
    parser.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "numpy", "native", "jax", "device"],
        help="pairwise alignment backend (auto picks by device and size;"
        " device needs a CUDA GPU)",
    )
    parser.add_argument(
        "--input", default=None, help="read problem from file instead of stdin"
    )
    parser.add_argument(
        "--batched",
        action="store_true",
        help="use the batched device engine (buckets pairs, shards over mesh)",
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="journal completed pairs to PATH and resume from it on restart"
        " (a {proc} placeholder expands to the process index)",
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="initialize the JAX distributed runtime (one process per GPU);"
        " pass --coordinator/--num-processes/--process-id",
    )
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument(
        "--platform",
        default=None,
        help="force the JAX platform (e.g. cpu), also where jax was"
        " imported with another platform before main() runs",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        metavar="DIR",
        help="emit a jax.profiler trace of the computation to DIR"
        " (defaults to MSA_TPU_PROFILE_DIR / config.profile_dir)",
    )
    args = parser.parse_args(argv)

    from msa_tpu.utils import jaxenv  # noqa: F401  (compile-cache setup)
    from msa_tpu.utils.msaio import parse_file, parse_input, format_output

    if args.platform:
        import jax as _jax

        _jax.config.update("jax_platforms", args.platform)

    if args.distributed:
        from msa_tpu.parallel.engine import init_distributed

        init_distributed(
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    if args.input:
        problem = parse_file(args.input)
    else:
        problem = parse_input(sys.stdin)

    from msa_tpu.config import DEFAULT
    from msa_tpu.ops.nw_gpu import NoGpuError
    from msa_tpu.utils.timing import profile

    start = time.time_ns() // 1000
    try:
        with profile(args.profile_dir or DEFAULT.profile_dir):
            if args.batched or args.distributed:
                from msa_tpu.parallel.engine import align_kway_sharded

                result = align_kway_sharded(
                    problem, backend=args.backend, checkpoint=args.checkpoint
                )
            else:
                from msa_tpu.models.kway import align_kway

                result = align_kway(
                    problem, backend=args.backend, checkpoint=args.checkpoint
                )
    except NoGpuError as e:
        sys.stderr.write(f"msa_tpu: {e}\n")
        return 1
    elapsed = time.time_ns() // 1000 - start

    # Every process computes the identical result; only process 0 owns
    # stdout (the reference printed from rank 0 only, submit:60-70).
    import jax

    if jax.process_index() == 0:
        sys.stdout.write(
            format_output(elapsed, result.chain_hash, result.penalties)
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
