"""Sharded k-way engine: mesh-parallel scores, multi-host pair execution.

Replaces the reference's MPI orchestration layers
(``submit/xuliny-seqalkway.cpp:232-417``):

- gene broadcast (S2, ``submit:248-266``)            -> replicated arrays /
  every process parses the same input;
- dynamic master-worker task queue (S7)              -> deterministic static
  LPT shard (``msa_tpu.parallel.schedule``);
- MPI_Send/Recv of Packets (``submit:305-331``)      -> device collectives
  (all_gather inside shard_map) for penalties, host-level allgather for
  per-pair hashes;
- hash-chain aggregation in task-id order (``submit:334-337``) -> identical
  fold, performed identically on every process (determinism by
  construction).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from msa_tpu.models.kway import KWayResult
from msa_tpu.ops.buckets import bucket_length
from msa_tpu.ops.nw_jax import _prep_pair, diag_sweep
from msa_tpu.parallel.mesh import get_mesh
from msa_tpu.parallel.schedule import schedule_for
from msa_tpu.utils.hashing import chain_hashes
from msa_tpu.utils.msaio import Problem
from msa_tpu.utils.tasks import pair_task_list


def _batched_scores(xpads, ybufs, ms, ns, pxy, pgap):
    """vmapped anti-diagonal score sweep over a stacked pair batch."""

    def one(xpad, ybuf, m, n):
        score, _, _ = diag_sweep(xpad, ybuf, m, n, pxy, pgap)
        return score

    return jax.vmap(one)(xpads, ybufs, ms, ns)


def sharded_pair_scores(
    genes: Sequence[str],
    pxy: int,
    pgap: int,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """All-pairs minimum penalties, pair-axis sharded over a device mesh.

    Pads every pair to a common bucket, stacks them, shards the stack over
    the ``pairs`` mesh axis, and runs the batched sweep under shard_map with
    an all_gather merge — the deterministic SPMD replacement for the
    reference's Packet collection loop.
    """
    if mesh is None:
        mesh = get_mesh()
    tasks = pair_task_list(len(genes))
    P_dev = mesh.devices.size

    @jax.jit
    def run(xpads, ybufs, ms, ns):
        def shard_fn(xp, yb, m_, n_):
            local = _batched_scores(xp, yb, m_, n_, pxy, pgap)
            return jax.lax.all_gather(local, "pairs", tiled=True)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("pairs"), P("pairs"), P("pairs"), P("pairs")),
            out_specs=P(),
            check_vma=False,  # all_gather(tiled) output is replicated
        )(xpads, ybufs, ms, ns)

    # Group pairs by padded-shape bucket so nothing pads to the global max
    # (on skewed workloads global-max padding more than doubles the cell
    # count); one compiled program per distinct bucket.
    by_bucket: dict = {}
    for t in tasks:
        Mp = bucket_length(max(len(genes[t.i]), len(genes[t.j])))
        by_bucket.setdefault(Mp, []).append(t)

    out = np.zeros(len(tasks), dtype=np.int64)
    for Mp, ts in sorted(by_bucket.items()):
        packed = [_prep_pair(genes[t.i], genes[t.j], Mp, Mp) for t in ts]
        num = len(packed)
        padded_num = -(-num // P_dev) * P_dev
        pad = padded_num - num
        # Pad with the bucket's CHEAPEST pair (fewest real cells), not
        # pair 0 — the bucket groups by padded shape, so the compiled
        # work is identical, but early-terminating lanes cost less
        # (the same lesson as ops/batch.py's padding choice).
        cheap = min(packed, key=lambda p: p[2] * p[3])
        xpads = np.stack([p[0] for p in packed] + [cheap[0]] * pad)
        ybufs = np.stack([p[1] for p in packed] + [cheap[1]] * pad)
        ms = np.array(
            [p[2] for p in packed] + [cheap[2]] * pad, dtype=np.int32
        )
        ns = np.array(
            [p[3] for p in packed] + [cheap[3]] * pad, dtype=np.int32
        )
        scores = run(
            jnp.asarray(xpads), jnp.asarray(ybufs), jnp.asarray(ms),
            jnp.asarray(ns),
        )
        for t, s in zip(ts, np.asarray(scores)[:num]):
            out[t.task_id] = int(s)
    return out


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX distributed runtime for a multi-process run.

    The replacement for the reference's
    ``MPI_Init_thread(MPI_THREAD_MULTIPLE)`` (``submit:38``). Pass the
    coordinator address, process count and id explicitly; nothing here
    detects a cluster. On GPUs run one process per card and give each its
    card with the launcher's ``CUDA_VISIBLE_DEVICES``, so every process
    sees exactly one local device. On the CPU, cross-process collectives
    ride gloo over the coordination service.
    """
    # gloo must be selected before the CPU client is created — and probing
    # the backend here would create it, so set it unconditionally (it only
    # affects CPU client construction).
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def _broadcast_calibration(log):
    """Process-0 device calibration, broadcast so every process agrees.

    The calibrated schedule is only deterministic if every process uses
    IDENTICAL cost-model parameters (the schedule is derived locally, the
    reference's testing8 design) — so process 0 measures and the values ride
    ``broadcast_one_to_all``. Returns None when calibration is unavailable
    (CPU-only, or inverted timings after retries).
    """
    import numpy as np

    from msa_tpu.parallel.costmodel import CalibratedCost, calibrate

    params = np.zeros(3, dtype=np.float64)
    if jax.process_index() == 0:
        model = calibrate()
        if model is not None:
            params[:] = (1.0, model.gcups, model.fixed_us)
    from jax.experimental import multihost_utils

    params = np.asarray(multihost_utils.broadcast_one_to_all(params))
    if params[0] < 1.0:
        return None
    model = CalibratedCost(gcups=float(params[1]), fixed_us=float(params[2]))
    log.info(
        "calibrated cost model: %.1f GCUPS, %.0f us fixed",
        model.gcups, model.fixed_us,
    )
    return model


def align_kway_sharded(
    problem: Problem,
    backend: str = "auto",
    keep_alignments: bool = False,
    checkpoint: Optional[str] = None,
) -> KWayResult:
    """Multi-host k-way engine.

    Every process derives the same LPT schedule, aligns its own pair shard
    on its local devices (big pairs through the batched device pipeline —
    the same path the single-chip engine uses), then all processes exchange
    (penalty, hash) results keyed by task id and fold the identical hash
    chain. Journals are per-process: a ``{proc}`` placeholder in the
    checkpoint path is expanded with the process index.
    """
    from msa_tpu.models.kway import KWayAligner
    from msa_tpu.utils.logging import get_logger
    from msa_tpu.utils.timing import StageTimer

    genes = problem.genes
    nproc = jax.process_count()
    pidx = jax.process_index()
    log = get_logger("msa_tpu.engine")
    timer = StageTimer()

    if checkpoint:
        checkpoint = checkpoint.replace("{proc}", str(pidx))

    if nproc == 1:
        # Single process: the k-way engine already batches big pairs into
        # one device call.
        return KWayAligner(
            problem.pxy, problem.pgap, backend=backend
        ).align_all(
            genes, keep_alignments=keep_alignments, checkpoint=checkpoint
        )

    with timer.stage("schedule"):
        from msa_tpu.config import DEFAULT

        policy = DEFAULT.schedule_policy
        cost_model = None
        if policy == "calibrated":
            cost_model = _broadcast_calibration(log)
            if cost_model is None:
                policy = "lpt"  # calibration unavailable -> exact m*n model
        shards = schedule_for(genes, nproc, policy=policy,
                              cost_model=cost_model)
        my_tasks = shards[pidx]
    log.info(
        "process %d/%d: %d of %d pairs (LPT)",
        pidx, nproc, len(my_tasks), problem.num_pairs,
    )

    aligner = KWayAligner(problem.pxy, problem.pgap, backend=backend)
    with timer.stage("align_shard"):
        my_results = aligner.align_tasks(
            genes, my_tasks, checkpoint=checkpoint
        )

    total = problem.num_pairs
    penalties = np.full(total, -1, dtype=np.int64)
    hash_bytes = np.zeros((total, 128), dtype=np.uint8)
    for r in my_results:
        penalties[r.task_id] = r.penalty
        hash_bytes[r.task_id] = np.frombuffer(
            r.problem_hash.encode("ascii"), dtype=np.uint8
        )

    with timer.stage("allgather_merge"):
        from jax.experimental import multihost_utils

        # Max-merge: unassigned slots are -1 / 0, each task owned by exactly
        # one process.
        penalties = np.asarray(
            multihost_utils.process_allgather(penalties)
        ).max(axis=0)
        hash_bytes = np.asarray(
            multihost_utils.process_allgather(hash_bytes)
        ).max(axis=0)

    with timer.stage("hash_chain"):
        pair_hashes = [
            bytes(hash_bytes[tid]).decode("ascii") for tid in range(total)
        ]
        chain = chain_hashes(pair_hashes)
    log.info("stage times:\n%s", timer.report())
    return KWayResult(
        chain_hash=chain,
        penalties=[int(p) for p in penalties],
        pair_results=my_results if keep_alignments else None,
    )
