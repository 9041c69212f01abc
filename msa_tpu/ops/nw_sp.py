"""Sequence-parallel (wavefront-sharded) NW sweep over a device mesh.

The reference's intra-pair axis (S3) split one DP matrix's anti-diagonals
across OpenMP threads (``submit/xuliny-seqalkway.cpp:462-491``). The mesh
analog shards the diagonal state vector across devices on a ``wave`` axis;
each step every device updates its lane chunk locally and receives the one
boundary lane it needs from its left neighbor via ``lax.ppermute``.

This is the scaling path for a *single giant pair* (pair-level data
parallelism, ``parallel.engine``, is the first choice whenever there are
many pairs — the reference measured the same tradeoff: SURVEY.md §2.2).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from msa_tpu.ops.nw_jax import NEG_FILL, _prep_pair

DIAG_MATCH, DIAG_SUB, UP, LEFT = 0, 1, 2, 3


def _wavefront_sweep_sharded(
    x: str,
    y: str,
    pxy: int,
    pgap: int,
    mesh: Mesh,
    axis: str = "pairs",
    ckpt_every: int = 0,
):
    """Sharded anti-diagonal sweep; optionally emit checkpoint diagonals.

    Returns ``(score, ckpts)``. With ``ckpt_every = C`` the sweep also emits,
    for every segment boundary ``d0 = s*C``, the two diagonals the segment
    recompute needs: ``ckpts[s, 0] = shift(diag_{d0-1})`` (host unshifts) and
    ``ckpts[s, 1] = diag_{d0}``, gathered across the mesh so the traceback
    (`nw_align_wavefront_sharded`) can re-derive any K-step window without
    the O(m*n) matrix.
    """
    D = mesh.shape[axis]
    xpad, ybuf, m, n, Mp, Np = _prep_pair(x, y)
    V = xpad.shape[0]
    Vp = -(-V // D) * D
    xpad = np.concatenate(
        [xpad, np.full(Vp - V, -1, dtype=np.int32)]
    )
    # Extra sentinel margin: the last device's y-window slice may clamp on
    # early (all-invalid) diagonals; keep it in range regardless. With
    # checkpointing the step count rounds up to a segment multiple, so the
    # margin covers the overrun too.
    margin = Vp + (ckpt_every or 0)
    ybuf = np.concatenate([ybuf, np.full(margin, -2, dtype=np.int32)])
    chunk = Vp // D
    y_off = V + Np  # same layout contract as nw_jax.diag_sweep

    @jax.jit
    def run(xpad_arr, ybuf_arr, m_, n_):
        def shard_fn(xp_local, yb):
            # xp_local: (chunk,) this device's lanes; yb replicated.
            dev = jax.lax.axis_index(axis)
            off = dev * chunk
            ii = off + jnp.arange(chunk, dtype=jnp.int32)
            vary0 = xp_local[0] * 0

            diag0 = (
                jnp.where(ii == 0, 0, NEG_FILL).astype(jnp.int32) + vary0
            )
            # prev1s must seed as shift(diagonal 0): global lane 1 holds
            # dp[0][0] = 0 (the diagonal neighbor of cell (1,1) at d=2).
            prev1s0 = (
                jnp.where(ii == 1, 0, NEG_FILL).astype(jnp.int32) + vary0
            )
            state = (
                jnp.full((chunk,), NEG_FILL, jnp.int32) + vary0,  # prev2s
                prev1s0,  # prev1s (shift of prev1)
                diag0,  # prev1 (= diagonal 0)
            )

            def shift_in(v):
                """shift(v)[l] = v[l-1]; lane 0 comes from left neighbor."""
                last = v[-1:]
                incoming = jax.lax.ppermute(
                    last, axis, [(i, i + 1) for i in range(D - 1)]
                )
                incoming = jnp.where(dev == 0, NEG_FILL, incoming)
                return jnp.concatenate([incoming, v[:-1]])

            def step(carry, d):
                prev2s, prev1s, prev1 = carry
                yd = jax.lax.dynamic_slice(
                    yb, (y_off - d + off,), (chunk,)
                )
                sub = jnp.where(xp_local == yd, 0, pxy)
                cur = jnp.minimum(
                    prev2s + sub,
                    jnp.minimum(prev1, prev1s) + pgap,
                )
                border = d * pgap
                cur = jnp.where((ii == 0) | (ii == d), border, cur)
                valid = (ii <= jnp.minimum(d, m_)) & (
                    ii >= jnp.maximum(0, d - n_)
                )
                cur = jnp.where(valid, cur, NEG_FILL)
                harvest = jnp.where(
                    (d == m_ + n_) & (ii == m_), cur, 0
                ).sum()
                return (prev1s, shift_in(cur), cur), harvest

            if not ckpt_every:
                ds = jnp.arange(1, Mp + Np + 1, dtype=jnp.int32)
                _, harvests = jax.lax.scan(step, state, ds)
                score = jax.lax.psum(jnp.sum(harvests), axis)[None]
                return score, jnp.zeros((1, 2, chunk), jnp.int32)

            n_seg = -(-(Mp + Np) // ckpt_every)

            def segment(carry, s_idx):
                prev2s, prev1s, prev1 = carry
                # Checkpoint entering segment s (d0 = s*C): the segment
                # recompute seeds from diag_{d0-1} (shifted carry) and
                # diag_{d0}.
                ck = jnp.stack([prev2s, prev1])
                d0 = s_idx * ckpt_every
                dsc = d0 + 1 + jnp.arange(ckpt_every, dtype=jnp.int32)
                carry2, harvests = jax.lax.scan(step, carry, dsc)
                return carry2, (ck, jnp.sum(harvests))

            _, (cks, harvests) = jax.lax.scan(
                segment, state, jnp.arange(n_seg, dtype=jnp.int32)
            )
            score = jax.lax.psum(jnp.sum(harvests), axis)[None]
            return score, cks

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=(P(axis), P(None, None, axis)),
            check_vma=False,
        )(xpad_arr, ybuf_arr)

    score, cks = run(
        jnp.asarray(xpad), jnp.asarray(ybuf), jnp.int32(m), jnp.int32(n)
    )
    return int(np.asarray(score)[0]), (
        np.asarray(cks) if ckpt_every else None
    )


def nw_score_wavefront_sharded(
    x: str,
    y: str,
    pxy: int,
    pgap: int,
    mesh: Mesh,
    axis: str = "pairs",
) -> int:
    """Minimum penalty with the diagonal state sharded over ``axis``."""
    score, _ = _wavefront_sweep_sharded(x, y, pxy, pgap, mesh, axis)
    return score


def _segment_dirs_host(
    xcodes: np.ndarray,
    ycodes: np.ndarray,
    ck_prev2s: np.ndarray,
    diag_d0: np.ndarray,
    d0: int,
    w0: int,
    W: int,
    steps: int,
    pxy: int,
    pgap: int,
    m: int,
    n: int,
) -> np.ndarray:
    """Re-derive one segment's move matrix over a narrow lane window.

    A windowed recompute: starting from the checkpoint diagonals at
    ``d0`` (``ck_prev2s`` is the sweep's *shifted* diag_{d0-1} carry, so the
    window slice needs no re-shifting), run ``steps`` diagonal updates over
    global lanes ``[w0, w0+W)`` and record the reference's tie-break moves.
    Exactness: contamination climbs one lane per step from the window base,
    and the traceback path at local step t sits at lane >= w0 + t (it
    moves at most one lane per step), so every cell the walk reads is
    exact.
    """
    NEG = NEG_FILL
    ii = np.arange(w0, w0 + W, dtype=np.int64)
    xw = np.where(
        (ii >= 1) & (ii <= m), xcodes[np.maximum(ii - 1, 0)], -1
    ).astype(np.int64)
    prev1 = diag_d0[w0 : w0 + W].astype(np.int64)
    prev1s = np.concatenate(([NEG], prev1[:-1]))
    prev2s = ck_prev2s[w0 : w0 + W].astype(np.int64)

    dirs = np.empty((steps, W), dtype=np.int8)
    for t in range(1, steps + 1):
        d = d0 + t
        yidx = d - ii - 1
        yd = np.where(
            (yidx >= 0) & (yidx < n), ycodes[np.clip(yidx, 0, n - 1)], -2
        ).astype(np.int64)
        match = xw == yd
        cd = prev2s + np.where(match, 0, pxy)
        cu = prev1s + pgap
        cl = prev1 + pgap
        cur = np.minimum(cd, np.minimum(cu, cl))
        dirs[t - 1] = np.where(
            match,
            DIAG_MATCH,
            np.where(cd == cur, DIAG_SUB, np.where(cu == cur, UP, LEFT)),
        )
        cur = np.where((ii == 0) | (ii == d), d * pgap, cur)
        valid = (ii <= min(d, m)) & (ii >= d - n)
        cur = np.where(valid, cur, NEG)
        prev2s = prev1s
        prev1s = np.concatenate(([NEG], cur[:-1]))
        prev1 = cur
    return dirs


def nw_align_wavefront_sharded(
    x: str,
    y: str,
    pxy: int,
    pgap: int,
    mesh: Mesh,
    axis: str = "pairs",
    ckpt_every: int = 512,
):
    """Penalty + byte-exact alignment for ONE giant pair over a device mesh.

    The O(m*n) fill runs wavefront-sharded across the mesh (every device
    owns a lane chunk, halo over ``ppermute``), emitting O((m+n)/C)
    checkpoint diagonals; the traceback then re-derives only a C-wide window
    per segment on the host — O((m+n)*C) work and memory, never the full
    matrix. This is the scaling path the reference's S3 could not reach:
    its wavefront stopped at one node's threads
    (``submit/xuliny-seqalkway.cpp:462-491``) and its traceback read a fully
    materialized matrix (``submit:502-531``).
    """
    from msa_tpu.utils.alignment import moves_to_alignment
    from msa_tpu.ops.reference import seq_to_codes

    m, n = len(x), len(y)
    if m == 0 or n == 0:
        from msa_tpu.ops.nw_jax import nw_align_jax

        return nw_align_jax(x, y, pxy, pgap)

    score, cks = _wavefront_sweep_sharded(
        x, y, pxy, pgap, mesh, axis, ckpt_every=ckpt_every
    )
    xcodes = seq_to_codes(x).astype(np.int64)
    ycodes = seq_to_codes(y).astype(np.int64)
    Vp = cks.shape[2]

    moves = []
    i, j = m, n
    while i > 0 and j > 0:
        d = i + j
        s = (d - 1) // ckpt_every
        d0 = s * ckpt_every
        steps = d - d0
        w0 = max(0, i - ckpt_every)
        W = min(i - w0 + 1, Vp - w0)
        dirs = _segment_dirs_host(
            xcodes, ycodes, cks[s, 0], cks[s, 1],
            d0, w0, W, steps, pxy, pgap, m, n,
        )
        while i > 0 and j > 0 and (i + j) > d0:
            mv = int(dirs[i + j - d0 - 1, i - w0])
            moves.append(mv)
            if mv <= DIAG_SUB:
                i -= 1
                j -= 1
            elif mv == UP:
                i -= 1
            else:
                j -= 1
    a1, a2 = moves_to_alignment(x, y, moves)
    return int(score), a1, a2
