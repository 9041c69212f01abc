"""k-way MSA by sum of pairwise alignments.

Replicates the reference's orchestration semantics
(``seqalign-mpi-skeleton.cpp:117-175``; distributed version
``submit/xuliny-seqalkway.cpp:232-364``): enumerate all k(k-1)/2 pairs in
canonical task order, align each pair, then fold the per-pair hashes into one
SHA-512 chain and collect penalties, both indexed by task id so the output is
independent of execution order and sharding.

The reference's dynamic MPI master-worker queue is replaced by a
deterministic schedule (``msa_tpu.parallel.schedule``): the DP cost model
cost = m*n is exact, so every participant derives the same assignment locally
— the design the reference itself validated in its ``testing8`` static-LPT
variant (``testing8/test.cpp:232-251``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from msa_tpu.models.pairwise import PairwiseAligner, PairResult
from msa_tpu.utils.hashing import chain_hashes
from msa_tpu.utils.msaio import Problem
from msa_tpu.utils.tasks import pair_task_list


@dataclasses.dataclass
class KWayResult:
    chain_hash: str
    penalties: List[int]
    pair_results: Optional[List[PairResult]] = None


# Boundary-row chunk of the opt-in band-striped single-pair fill.
_STRIPE_KCHUNK = 1024


class KWayAligner:
    """All-pairs aligner.

    ``kernels`` substitutes the device path's kernel set (``ops/nw_gpu``):
    None runs the CUDA kernels, which need a GPU; tests pass the plain-JAX
    twin so the device routing runs on the CPU.
    """

    def __init__(self, pxy: int, pgap: int, backend: str = "auto",
                 kernels=None):
        if backend == "device" and kernels is None:
            from msa_tpu.ops.nw_gpu import require_gpu

            require_gpu()
        self.pairwise = PairwiseAligner(pxy, pgap, backend=backend)
        self.kernels = kernels

    def align_tasks(
        self,
        genes: Sequence[str],
        tasks: Sequence,
        checkpoint: Optional[str] = None,
    ) -> List[PairResult]:
        """Align an arbitrary task subset; results in the given task order.

        This is the per-shard work unit of the multi-host engine
        (``parallel.engine``): big pairs go through the batched device
        pipeline, the rest through the host path, journal-resumable.
        The reference analog is the worker loop that executed whatever
        tasks arrived (``submit/xuliny-seqalkway.cpp:369-417``) — here the
        shard is an input, not a message stream.
        """
        results: dict = {}

        journal = None
        if checkpoint:
            from msa_tpu.utils.checkpoint import PairJournal, problem_key

            journal = PairJournal(
                checkpoint,
                problem_key(self.pairwise.pxy, self.pairwise.pgap, genes),
            )
            done = journal.load()
            for t in tasks:
                if t.task_id in done:
                    penalty, h = done[t.task_id]
                    results[t.task_id] = PairResult(
                        t.task_id, penalty, "", "", h
                    )

        remaining = [t for t in tasks if t.task_id not in results]
        remaining = self._maybe_striped(genes, remaining, results, journal)
        batched = self._batched_tasks(genes, remaining)
        if batched:
            from msa_tpu.utils.hashing import pair_hash

            on_task_result = None
            if journal is not None:
                # Journal each pair AS its walk decodes (the decode loop
                # sees results incrementally), not after the whole device
                # workload returns — a crash mid-workload preserves every
                # finished pair. Callbacks may fire from per-device
                # threads, so serialize the journal writes.
                import threading

                jlock = threading.Lock()

                def on_task_result(t, triple):
                    penalty, a1, a2 = triple
                    with jlock:
                        journal.record(t.task_id, penalty, pair_hash(a1, a2))

            triples = self._run_batched(
                genes, batched, on_task_result=on_task_result
            )
            for t, (penalty, a1, a2) in zip(batched, triples):
                results[t.task_id] = PairResult(
                    t.task_id, penalty, a1, a2, pair_hash(a1, a2)
                )

        for t in tasks:
            if t.task_id not in results:
                results[t.task_id] = self.pairwise.do_task(
                    t.task_id, genes[t.i], genes[t.j]
                )
                if journal is not None:
                    r = results[t.task_id]
                    journal.record(t.task_id, r.penalty, r.problem_hash)
        if journal is not None:
            journal.close()
        return [results[t.task_id] for t in tasks]

    def align_all(
        self,
        genes: Sequence[str],
        keep_alignments: bool = False,
        checkpoint: Optional[str] = None,
    ) -> KWayResult:
        tasks = pair_task_list(len(genes))
        results = self.align_tasks(genes, tasks, checkpoint=checkpoint)
        penalties = [r.penalty for r in results]
        chain = chain_hashes(r.problem_hash for r in results)
        return KWayResult(
            chain_hash=chain,
            penalties=penalties,
            pair_results=results if keep_alignments else None,
        )

    def _maybe_striped(self, genes, remaining, results, journal):
        """Opt-in: a lone giant pair spans ALL local devices, band-striped.

        ``config.single_pair_striped`` routes a workload whose only big
        pair cannot be pair-parallelized (nothing to shard) through
        ``ops/nw_striped`` — every device fills a row stripe, boundary
        rows stream in K-chunks (the reference's S3 scaled across devices,
        ``submit/xuliny-seqalkway.cpp:462-491``). Off by default.
        """
        from msa_tpu.config import DEFAULT

        if not DEFAULT.single_pair_striped or self.pairwise.backend not in (
            "device", "auto"
        ):
            return remaining
        big = [
            t for t in remaining
            if len(genes[t.i]) * len(genes[t.j]) > DEFAULT.small_threshold
        ]
        if len(big) != 1:
            return remaining
        import jax

        if len(jax.local_devices()) < 2:
            return remaining
        from msa_tpu.ops.nw_striped import nw_align_band_striped
        from msa_tpu.parallel.mesh import get_mesh
        from msa_tpu.utils.hashing import pair_hash
        from msa_tpu.utils.logging import get_logger

        t = big[0]
        get_logger("msa_tpu.kway").info(
            "lone big pair (%d x %d): band-striped across %d devices",
            len(genes[t.i]), len(genes[t.j]), len(jax.local_devices()),
        )
        penalty, a1, a2 = nw_align_band_striped(
            genes[t.i], genes[t.j], self.pairwise.pxy, self.pairwise.pgap,
            get_mesh(), kchunk=_STRIPE_KCHUNK,
        )
        results[t.task_id] = PairResult(
            t.task_id, penalty, a1, a2, pair_hash(a1, a2)
        )
        if journal is not None:
            journal.record(t.task_id, penalty, pair_hash(a1, a2))
        return [r for r in remaining if r.task_id != t.task_id]

    def _run_batched(self, genes: Sequence[str], batched, on_task_result=None):
        """Run the device path, sharded over the process's local devices.

        The reference got its speedup by running the full per-pair task on
        every rank (``submit/xuliny-seqalkway.cpp:369-417``); the
        local-device analog is an LPT split of the big pairs with the whole
        fill + walk + decode running per device, one host thread each.
        Results come back in ``batched`` order; the split is deterministic
        (LPT, ties by task id), so output never depends on thread timing.
        """
        import jax

        from msa_tpu.config import DEFAULT
        from msa_tpu.ops.nw_gpu import align_pairs

        pxy, pgap = self.pairwise.pxy, self.pairwise.pgap

        def run_on(dev, tasks_d):
            cb = None
            if on_task_result is not None:
                def cb(idx, triple, tasks_d=tasks_d):
                    on_task_result(tasks_d[idx], triple)

            return align_pairs(
                genes, [(t.i, t.j) for t in tasks_d], pxy, pgap,
                kernels=self.kernels, device=dev, on_result=cb,
            )

        devs = jax.local_devices()
        limit = DEFAULT.local_devices or len(devs)
        n_used = max(1, min(len(devs), limit, len(batched)))
        if n_used == 1:
            return run_on(devs[0], batched)

        from concurrent.futures import ThreadPoolExecutor

        from msa_tpu.parallel.schedule import lpt_schedule

        costs = [(t, len(genes[t.i]) * len(genes[t.j])) for t in batched]
        shards = [s for s in lpt_schedule(costs, n_used) if s]
        by_id = {}
        with ThreadPoolExecutor(max_workers=len(shards)) as pool:
            futs = [
                pool.submit(run_on, devs[d], shard)
                for d, shard in enumerate(shards)
            ]
            for tasks_d, fut in zip(shards, futs):
                for t, triple in zip(tasks_d, fut.result()):
                    by_id[t.task_id] = triple
        return [by_id[t.task_id] for t in batched]

    def _batched_tasks(self, genes: Sequence[str], tasks):
        """Pairs above ``small_threshold`` cells, for the device path.

        ``auto`` sends them there only on a GPU (on the CPU it keeps the
        host kernels); ``device`` always does, and was refused at
        construction where there is no GPU. Injected kernels run wherever
        JAX runs.
        """
        from msa_tpu.config import DEFAULT

        backend = self.pairwise.backend
        if backend not in ("device", "auto"):
            return []
        if backend == "auto" and self.kernels is None:
            import jax

            if jax.default_backend() != "gpu":
                return []
        return [
            t for t in tasks
            if len(genes[t.i]) * len(genes[t.j]) > DEFAULT.small_threshold
        ]


def align_kway(
    problem: Problem,
    backend: str = "auto",
    keep_alignments: bool = False,
    checkpoint: Optional[str] = None,
    kernels=None,
) -> KWayResult:
    """One-shot driver: Problem -> (chain hash, penalties)."""
    engine = KWayAligner(
        problem.pxy, problem.pgap, backend=backend, kernels=kernels
    )
    return engine.align_all(
        problem.genes,
        keep_alignments=keep_alignments,
        checkpoint=checkpoint,
    )
