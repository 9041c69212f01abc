"""Anti-diagonal Needleman–Wunsch sweep in pure jnp (XLA-compiled).

A re-design of the reference's OpenMP wavefront kernel
(``submit/xuliny-seqalkway.cpp:419-566``): instead of a tile grid over
threads, one ``lax.scan`` walks the m+n anti-diagonals; each step is a
vectorized update over a whole diagonal. Memory is O(min-side) for
scores; the dirs matrix (for traceback) is emitted per-diagonal and
reassembled. Big pairs use the device fill + walk (``msa_tpu.ops.nw_gpu``)
instead; sharded checkpoint emission for giant pairs lives in
``msa_tpu.ops.nw_sp``.

Shapes are static (bucket-padded); actual lengths ``m, n`` ride in as traced
scalars, so one compiled program serves a whole shape bucket.

Diagonal coordinate system: diagonal ``d`` holds cells ``(i, j=d-i)``;
state vectors are indexed by ``i`` (0..Mp). Neighbors:

    left (i, j-1)  -> diag d-1, index i
    up   (i-1, j)  -> diag d-1, index i-1
    diag (i-1,j-1) -> diag d-2, index i-1
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from msa_tpu.ops.buckets import X_SENTINEL, Y_SENTINEL, bucket_length, encode_padded

NEG_FILL = 2**30  # "+inf"-ish filler for invalid lanes

DIAG_MATCH, DIAG_SUB, UP, LEFT = 0, 1, 2, 3


def _shift1(v: jnp.ndarray, fill=NEG_FILL) -> jnp.ndarray:
    """shift(v)[i] = v[i-1]; index 0 gets ``fill``."""
    return jnp.concatenate([jnp.full((1,), fill, v.dtype), v[:-1]])


def _diag_step(
    d: jnp.ndarray,
    prev1: jnp.ndarray,
    prev2: jnp.ndarray,
    xpad: jnp.ndarray,
    ybuf: jnp.ndarray,
    m: jnp.ndarray,
    n: jnp.ndarray,
    pxy: jnp.ndarray,
    pgap: jnp.ndarray,
    ii: jnp.ndarray,
    y_off: int,
    swap: jnp.ndarray,
):
    """One anti-diagonal update. Returns (cur, dirs) vectors of length V.

    ``xpad[i] = code(x[i-1])`` (index 0 is a sentinel).
    ``ybuf`` is reversed-y inside a sentinel-padded buffer such that
    ``ybuf[y_off - d + i] = code(y[d-i-1])`` for all reachable (d, i).
    """
    V = prev1.shape[0]
    yd = jax.lax.dynamic_slice(ybuf, (y_off - d,), (V,))
    match = xpad == yd
    sub = jnp.where(match, 0, pxy)

    up = _shift1(prev1)
    left = prev1
    diag = _shift1(prev2)

    cand_diag = diag + sub
    cand_up = up + pgap
    cand_left = left + pgap
    cur = jnp.minimum(cand_diag, jnp.minimum(cand_up, cand_left))

    # Traceback moves with the reference tie-break order
    # (seqalign-mpi-skeleton.cpp:236-262): match > diag > up > left.
    # ``swap = 1`` runs a transposed pair (x/y exchanged by the caller to
    # keep the scan state on the SHORT side): up/left exchange under
    # transpose, so ties must then prefer LEFT (strict compare) for the
    # caller's swap-back to reproduce the original orientation's
    # alignment byte-exactly.
    dirs = jnp.where(
        match,
        DIAG_MATCH,
        jnp.where(
            cand_diag == cur,
            DIAG_SUB,
            jnp.where(
                (cand_up == cur) & (cand_up + swap <= cand_left),
                UP,
                LEFT,
            ),
        ),
    ).astype(jnp.int8)

    # Borders: dp[i][0] = i*pgap (cell i==d), dp[0][j] = j*pgap (cell i==0).
    border = d * pgap
    cur = jnp.where((ii == 0) | (ii == d), border, cur)

    # Invalid lanes (outside the actual m x n rectangle) get +inf so they
    # never win a min in later steps.
    valid = (ii <= jnp.minimum(d, m)) & (ii >= jnp.maximum(0, d - n))
    cur = jnp.where(valid, cur, NEG_FILL)
    return cur, dirs


@functools.partial(
    jax.jit, static_argnames=("emit_dirs", "unroll")
)
def diag_sweep(
    xpad: jnp.ndarray,  # (Mp+1,) int32; xpad[i] = code(x[i-1]), xpad[0] sentinel
    ybuf: jnp.ndarray,  # (y_off + Mp + 2,) int32 reversed-y buffer
    m: jnp.ndarray,  # () int32 actual length of x
    n: jnp.ndarray,  # () int32 actual length of y
    pxy: jnp.ndarray,
    pgap: jnp.ndarray,
    *,
    swap: jnp.ndarray = 0,
    emit_dirs: bool = False,
    unroll: int = 1,
):
    """Run the full sweep. Returns (score, dirs_diag, None).

    - score: dp[m][n] (int32 scalar)
    - dirs_diag: (D, V) int8 with dirs_diag[d-1, i] = move of cell (i, d-i),
      or None
    """
    V = xpad.shape[0]  # Mp + 1
    Np = ybuf.shape[0] - 2 * V - 1
    y_off = V + Np  # ybuf[y_off - d + i] == y[d-i-1]
    D = (V - 1) + Np  # number of diagonals to process (d = 1..D)

    ii = jnp.arange(V, dtype=jnp.int32)

    # Tie the initial carry's type to the inputs: under shard_map the inputs
    # carry a varying manual axis, and a constant-built scan carry would
    # otherwise mismatch the (varying) carry output.
    vary0 = xpad[0] * 0

    # d = 0 diagonal: dp[0][0] = 0. The scan carries (prev2, prev1) =
    # diagonals (d-2, d-1); the dummy "d = -1" diagonal is all +inf.
    prev2 = jnp.where(ii == 0, 0, NEG_FILL).astype(jnp.int32) + vary0
    state = (jnp.full((V,), NEG_FILL, jnp.int32) + vary0, prev2)

    pxy = jnp.asarray(pxy, jnp.int32)
    pgap = jnp.asarray(pgap, jnp.int32)

    def step(carry, d):
        prev2, prev1 = carry
        cur, dirs = _diag_step(
            d, prev1, prev2, xpad, ybuf, m, n, pxy, pgap, ii, y_off,
            jnp.asarray(swap, jnp.int32),
        )
        # Harvest the final score when this diagonal contains (m, n).
        out = dirs if emit_dirs else jnp.zeros((0,), jnp.int8)
        return (prev1, cur), (out, jnp.where(d == m + n, cur[m], 0))

    ds = jnp.arange(1, D + 1, dtype=jnp.int32)

    _, (dirs_all, scores) = jax.lax.scan(step, state, ds, unroll=unroll)
    score = jnp.max(scores)
    return score, (dirs_all if emit_dirs else None), None


def _prep_pair(x: str, y: str, Mp: Optional[int] = None, Np: Optional[int] = None):
    """Host-side packing of one pair into sweep inputs."""
    m, n = len(x), len(y)
    Mp = Mp if Mp is not None else bucket_length(m)
    Np = Np if Np is not None else bucket_length(n)
    V = Mp + 1
    xcodes = encode_padded(x, Mp, X_SENTINEL)
    xpad = np.concatenate([[np.int32(X_SENTINEL)], xcodes]).astype(np.int32)
    yrev = encode_padded(y, Np, Y_SENTINEL)[::-1].copy()
    # ybuf layout: [V sentinels | yrev (Np) | V+1 sentinels]. With
    # y_off = V + Np, ybuf[y_off - d + i] = y[d-i-1], and every slice start
    # y_off - d stays >= 1 for d <= Mp+Np (dynamic_slice must never clamp,
    # or all lanes would shift).
    ybuf = np.concatenate(
        [
            np.full(V, Y_SENTINEL, dtype=np.int32),
            yrev,
            np.full(V + 1, Y_SENTINEL, dtype=np.int32),
        ]
    ).astype(np.int32)
    return xpad, ybuf, m, n, Mp, Np


def nw_score_jax(x: str, y: str, pxy: int, pgap: int) -> int:
    """Minimum penalty via the jitted diagonal sweep (O(diag) memory)."""
    xpad, ybuf, m, n, _, _ = _prep_pair(x, y)
    score, _, _ = diag_sweep(
        jnp.asarray(xpad), jnp.asarray(ybuf),
        jnp.int32(m), jnp.int32(n), pxy, pgap,
    )
    return int(score)


def nw_align_jax(x: str, y: str, pxy: int, pgap: int) -> Tuple[int, str, str]:
    """Penalty + alignment via full per-diagonal dirs (small/medium pairs).

    Memory: (Mp+Np) x (Mp+1) int8 with x the SHORT side — the sweep state
    (and each emitted dirs diagonal) is indexed by x, so a skewed pair run
    long-side-first emits an O((m+n)*m) dirs buffer: 70000x24 (the
    ``data/xulin_adversarial.dat`` shape) would be 4.6 GB and ~100 s of
    device->host fetch, which is why the adversarial conformance run never
    finished in rounds 1-3. Transposed runs flip the up/left tie-break
    (``swap``) and swap the alignments back, preserving the reference's
    byte-exact output. Big pairs use the device fill + walk
    (``msa_tpu.ops.nw_gpu``) instead.
    """
    from msa_tpu.utils.alignment import moves_to_alignment

    swapped = len(x) > len(y)
    xs, ys = (y, x) if swapped else (x, y)
    xpad, ybuf, m, n, Mp, Np = _prep_pair(xs, ys)
    score, dirs_diag, _ = diag_sweep(
        jnp.asarray(xpad), jnp.asarray(ybuf),
        jnp.int32(m), jnp.int32(n), pxy, pgap,
        swap=jnp.int32(1 if swapped else 0),
        emit_dirs=True,
    )
    dirs_diag = np.asarray(dirs_diag)  # (D, V); row d-1 = diagonal d
    moves = _walk_diag(dirs_diag, m, n)
    a1, a2 = moves_to_alignment(xs, ys, moves)
    if swapped:
        a1, a2 = a2, a1
    return int(score), a1, a2


def _walk_diag(dirs_diag: np.ndarray, m: int, n: int):
    """Walk dirs stored per-diagonal: move of (i, j) at [i+j-1, i]."""
    i, j = m, n
    moves = []
    while i != 0 and j != 0:
        mv = int(dirs_diag[i + j - 1, i])
        moves.append(mv)
        if mv <= DIAG_SUB:
            i -= 1
            j -= 1
        elif mv == UP:
            i -= 1
        else:
            j -= 1
    return moves
