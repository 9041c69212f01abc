"""Smoke run of the whole system on one H100 (or four, with --four-cards).

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # big13 over 4 cards, two routes

One card, in one process:

1. device: JAX's device and ``nvidia-smi``'s name and power limit; stops
   unless the platform is ``gpu``;
2. build: the CUDA library from ``msa_tpu/native/nw_cuda.cu`` (set-up);
3. kernels: the CUDA fill and walk against their plain-JAX twins on
   big13's three largest pairs, penalties and moves byte for byte, each
   timed cold (compile included) and warm;
4. big13: ``align_kway`` with the CUDA kernels cold and warm, then with
   the plain twins, each against the full golden hash and all 78
   penalties; the fill program's ``memory_analysis()`` and the peak
   device memory;
5. datasets: every other bundled dataset against its golden.

Four cards: big13 (a) in one process over all four cards (``_run_batched``,
one thread per card) and (b) as four CLI processes under
``--distributed``, one card each by ``CUDA_VISIBLE_DEVICES``; both against
the golden hash. The parent stays off JAX until (b) has finished.

Any failure exits non-zero before the result line. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from msa_tpu.utils import jaxenv  # noqa: E402,F401  (compile cache setup)
from msa_tpu.utils import goldens  # noqa: E402

BIG13 = "mseq-big13-example.txt"
OTHER_DATASETS = (
    "mseq.dat", "mseq1.dat", "mseq-big13-example2.txt", "xulin_test.txt",
    "xulin_adversarial.dat",
)


class Failed(Exception):
    pass


def log(*args):
    print(*args, flush=True)


def phase(name, fn, *args):
    t0 = time.perf_counter()
    log(f"== {name}")
    out = fn(*args)
    log(f"== {name}: ok in {time.perf_counter() - t0:.3f} s")
    return out


def expect(ok, what):
    if not ok:
        raise Failed(what)


def timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _problem(name):
    from msa_tpu.utils.msaio import parse_file

    return parse_file(os.path.join(goldens.DATA, name))


def build():
    from msa_tpu.native.build import build_cuda
    from msa_tpu.ops.nw_gpu import register_cuda

    t0 = time.perf_counter()
    build_cuda(force=True)
    log(f"nvcc build: {time.perf_counter() - t0:.3f} s (set-up)")
    register_cuda()


def kernels_vs_plain(dev):
    """CUDA fill and walk equal their plain twins on big13's 3 largest pairs."""
    import jax.numpy as jnp
    import numpy as np

    from msa_tpu.ops.nw_gpu import CUDA, PLAIN
    from msa_tpu.utils.tasks import pair_task_list

    problem = _problem(BIG13)
    genes = problem.genes
    tasks = sorted(
        pair_task_list(len(genes)),
        key=lambda t: -len(genes[t.i]) * len(genes[t.j]),
    )[:3]
    pairs = [(t.i, t.j) for t in tasks]
    log("pairs:", [(len(genes[i]), len(genes[j])) for i, j in pairs])
    cells = sum(len(genes[i]) * len(genes[j]) for i, j in pairs)
    res = {}
    for k in (CUDA, PLAIN):
        g = k.prepare(genes, pairs, dev)
        (scores, moves), cold = timed(lambda: k.fill(g, problem.pxy, problem.pgap))
        (scores, moves), warm = timed(lambda: k.fill(g, problem.pxy, problem.pgap))
        log(f"{k.name} fill: cold {cold:.3f} s, warm {warm:.3f} s"
            f" = {cells / warm / 1e9:.1f} GCUPS")
        (streams, counts), wcold = timed(lambda: k.walk(g, moves))
        (streams, counts), wwarm = timed(lambda: k.walk(g, moves))
        log(f"{k.name} walk: cold {wcold:.3f} s, warm {wwarm:.3f} s")
        res[k.name] = (k, g, scores, moves, np.asarray(streams),
                       np.asarray(counts))
    kc, gc, sc, mc, stc, cc = res["cuda"]
    kp, gp, sp, mp, stp, cp = res["plain"]
    expect((np.asarray(sc) == np.asarray(sp)).all(), "fill penalties differ")
    for p in range(len(pairs)):
        same = bool(jnp.array_equal(kc.pair_moves(gc, mc, p),
                                    kp.pair_moves(gp, mp, p)))
        expect(same, f"fill moves differ on pair {pairs[p]}")
    expect((cc == cp).all(), "walk lengths differ")
    for p in range(len(pairs)):
        expect((stc[p, : cc[p]] == stp[p, : cp[p]]).all(),
               f"walk streams differ on pair {pairs[p]}")
    log("penalties:", [int(v) for v in np.asarray(sc)],
        "moves and streams equal byte for byte")


def big13(dev):
    from msa_tpu.models.kway import align_kway
    from msa_tpu.ops.nw_gpu import CUDA, PLAIN

    problem = _problem(BIG13)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        r = align_kway(problem, backend="device")
        dt = time.perf_counter() - t0
        expect(goldens.check(BIG13, r.chain_hash, r.penalties),
               f"big13 ({label}) does not match the golden")
        log(f"big13 cuda {label}: {dt:.3f} s = {2.78525e11 / dt / 1e9:.1f}"
            f" GCUPS, hash {r.chain_hash}")
    log("penalties:", " ".join(map(str, r.penalties)))
    stats = dev.memory_stats()
    log("peak_bytes_in_use:", stats.get("peak_bytes_in_use"),
        "bytes_limit:", stats.get("bytes_limit"))
    from msa_tpu.utils.tasks import pair_task_list

    genes = problem.genes
    pairs = [(t.i, t.j) for t in pair_task_list(len(genes))]
    groups = CUDA.plan([(len(genes[i]), len(genes[j])) for i, j in pairs], dev)
    log("groups:", [len(g) for g in groups])
    g = CUDA.prepare(genes, [pairs[p] for p in groups[0]], dev)
    log("group 0 fill memory_analysis:",
        CUDA.lower(g, problem.pxy, problem.pgap).compile().memory_analysis())
    del g
    t0 = time.perf_counter()
    r = align_kway(problem, backend="device", kernels=PLAIN)
    dt = time.perf_counter() - t0
    expect(goldens.check(BIG13, r.chain_hash, r.penalties),
           "big13 with the plain twins does not match the golden")
    log(f"big13 plain (cold): {dt:.3f} s = {2.78525e11 / dt / 1e9:.1f} GCUPS")


def datasets():
    from msa_tpu.models.kway import align_kway

    for name in OTHER_DATASETS:
        t0 = time.perf_counter()
        r = align_kway(_problem(name), backend="auto")
        dt = time.perf_counter() - t0
        expect(goldens.check(name, r.chain_hash, r.penalties),
               f"{name} does not match its golden")
        log(f"{name}: golden ok, {dt:.3f} s (cold), hash {r.chain_hash[:16]}")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cli_processes(n):
    """Route (b): n CLI processes, one card each, under --distributed."""
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for pid in range(n):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "msa_tpu.cli", "--distributed",
             "--coordinator", f"localhost:{port}", "--num-processes", str(n),
             "--process-id", str(pid), "--backend", "device",
             "--input", os.path.join(goldens.DATA, BIG13)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            outs.append(out)
            expect(p.returncode == 0, f"CLI process failed:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    lines = outs[0].splitlines()
    h = lines.index(goldens.BIG13_HASH) if goldens.BIG13_HASH in lines else -1
    expect(h >= 0, f"route (b): golden hash not printed:\n{outs[0][-2000:]}")
    pen = [int(v) for v in lines[h + 1].split()]
    expect(pen == goldens.BIG13_PENALTIES, "route (b): penalties differ")
    log(f"route (b) {n} CLI processes: golden ok, {dt:.3f} s wall"
        f" (process start and compile included), {lines[h - 1]}")


def one_process_four_cards():
    """Route (a): one process, pairs LPT-split over every local card."""
    import jax

    from msa_tpu.models.kway import align_kway

    expect(len(jax.local_devices()) == 4, "route (a) needs 4 local cards")
    problem = _problem(BIG13)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        r = align_kway(problem, backend="device")
        dt = time.perf_counter() - t0
        expect(goldens.check(BIG13, r.chain_hash, r.penalties),
               f"route (a) {label}: big13 does not match the golden")
        log(f"route (a) one process x 4 cards {label}: golden ok, {dt:.3f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run big13 over four cards by both routes only")
    args = ap.parse_args(argv)
    from msa_tpu.utils import device

    try:
        if args.four_cards:
            # No JAX in this process until the CLI processes are done: a
            # JAX process holds most of each card's memory.
            log("nvidia-smi:", device.nvidia_smi().replace("\n", " | "))
            phase("route (b)", four_cli_processes, 4)
            info = device.describe()
            log("device:", json.dumps(info))
            expect(info["platform"] == "gpu", "JAX finds no GPU")
            phase("route (a)", one_process_four_cards)
        else:
            info = device.describe()
            log("device:", json.dumps(info))
            if info["platform"] != "gpu":
                log("no GPU: nothing to smoke-test")
                return 1
            log("nvidia-smi:", device.nvidia_smi())
            import jax

            dev = jax.devices()[0]
            phase("build", build)
            phase("kernels", kernels_vs_plain, dev)
            phase("big13", big13, dev)
            phase("datasets", datasets)
    except Failed as e:
        log(f"FAILED: {e}")
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
