"""Big-pair device path: grouped fill to stored 2-bit moves, device walk.

Every pair above ``small_threshold`` cells takes this path
(``models/kway``). It works in three steps:

1. **Plan.** Pairs are split into groups whose device buffers fit what the
   device has left (``memory_stats()``: ``bytes_limit - bytes_in_use``).
   A device that reports no limit is an error, and so is a pair that does
   not fit alone. A group the allocator still refuses (free memory need
   not be contiguous) is halved and retried.
2. **Fill.** One call per group writes every pair's penalty and its full
   move matrix, 2 bits a cell, into device memory. Moves follow the
   reference's tie-break, match > diagonal > up > left
   (``seqalign-mpi-skeleton.cpp:236-262``), in each pair's canonical
   (i, j) orientation.
3. **Walk and decode.** A device walk turns each pair's moves into its
   O(m+n) move stream; only the streams reach the host, where
   ``moves_to_alignment`` and the hash chain finish.

Two kernel sets implement steps 2 and 3 under one contract (the move
layout is described in ``msa_tpu/native/nw_cuda.cu``):

- ``CUDA``: the production kernels, CUDA C++ for Hopper called through
  ``jax.ffi`` (targets ``nw_fill`` and ``nw_walk``).
- ``PLAIN``: the same contract in ``jax.numpy``/``lax`` (a row scan whose
  left-to-right dependency is a prefix minimum, ``vmap``ped over the group;
  the walk a ``lax.while_loop``). It is the reference the CUDA kernels are
  checked against on the card, and what the CPU tests run. It is never a
  fallback for the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from msa_tpu.utils.alignment import moves_to_alignment

# Rows one warp of the CUDA fill owns; must equal kStripRows in nw_cuda.cu
# (the handler refuses a mismatch).
STRIP_ROWS = 256
TABLE_COLS = 8
_ALIGN = 256  # allocation granularity assumed for each pair's moves

Pair = Tuple[int, int]


class NoGpuError(RuntimeError):
    """The device path was asked for where JAX sees no CUDA GPU."""


def require_gpu() -> None:
    backend = jax.default_backend()
    if backend != "gpu":
        raise NoGpuError(
            f"the device backend needs a CUDA GPU; JAX found {backend!r}"
        )


def row_bytes(n: int) -> int:
    """Bytes of one move row: ceil(n/16) little-endian uint32 words."""
    return 4 * (-(-n // 16))


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def device_budget(device) -> int:
    """Bytes the device can still hand out: its limit less what is in use."""
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device} reports no memory limit; cannot plan groups"
        )
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))


def plan_groups(
    dims: Sequence[Tuple[int, int]],
    budget: int,
    group_bytes: Callable[[Sequence[Tuple[int, int]]], int],
) -> List[List[int]]:
    """Split pair indices into groups whose ``group_bytes`` fit ``budget``.

    Next fit over pairs in decreasing m*n: each pair is placed exactly once,
    in the open group if it still fits, else in a new one. Raises if a pair
    does not fit alone.
    """
    order = sorted(range(len(dims)), key=lambda p: (-dims[p][0] * dims[p][1], p))
    groups: List[List[int]] = []
    cur: List[int] = []
    for p in order:
        if group_bytes([dims[p]]) > budget:
            m, n = dims[p]
            raise MemoryError(
                f"pair {m}x{n} needs {group_bytes([dims[p]])} bytes alone;"
                f" the device has {budget}"
            )
        if cur and group_bytes([dims[q] for q in cur + [p]]) > budget:
            groups.append(cur)
            cur = []
        cur.append(p)
    if cur:
        groups.append(cur)
    return groups


# --------------------------------------------------------------------------
# CUDA kernels (jax.ffi)

_REGISTER_LOCK = threading.Lock()
_REGISTERED: List[str] = []


def register_cuda() -> str:
    """Build (if stale) and register the CUDA targets once; returns the path."""
    with _REGISTER_LOCK:
        if _REGISTERED:
            return _REGISTERED[0]
        import ctypes

        from msa_tpu.native.build import build_cuda

        path = build_cuda()
        lib = ctypes.cdll.LoadLibrary(path)
        jax.ffi.register_ffi_target(
            "nw_fill", jax.ffi.pycapsule(lib.NwFill), platform="CUDA"
        )
        jax.ffi.register_ffi_target(
            "nw_walk", jax.ffi.pycapsule(lib.NwWalk), platform="CUDA"
        )
        _REGISTERED.append(path)
        return path


@dataclasses.dataclass
class CudaGroup:
    """Host-side inputs of one CUDA group call."""

    seqs: np.ndarray  # uint8, the group's genes back to back
    table: np.ndarray  # int32 [P, 8], see nw_cuda.cu
    tickets: np.ndarray  # int32 [S, 2]: (pair, strip), each pair in order
    move_sizes: Tuple[int, ...]  # bytes of each pair's moves, m*row_bytes(n)
    aux_len: int  # int32 words: pointers, row buffers, flags, ticket counter
    max_len: int  # longest move stream, max(m + n)


def cuda_group(genes: Sequence[str], pairs: Sequence[Pair]) -> CudaGroup:
    used = sorted({g for ij in pairs for g in ij})
    offs, blobs, pos = {}, [], 0
    for g in used:
        offs[g] = pos
        blobs.append(genes[g].encode("latin-1"))
        pos += len(blobs[-1])
    seqs = np.frombuffer(b"".join(blobs) + b"\0", dtype=np.uint8)
    table = np.zeros((len(pairs), TABLE_COLS), dtype=np.int32)
    strips = []
    hrow_off = strip_base = 0
    for p, (i, j) in enumerate(pairs):
        m, n = len(genes[i]), len(genes[j])
        s = -(-m // STRIP_ROWS)
        table[p] = [offs[i], offs[j], m, n, hrow_off, strip_base, 0, 0]
        hrow_off += n
        strip_base += s
        strips.append(s)
    # Round robin over pairs, strips of one pair in order: every pair's
    # wavefront advances at once, and a strip waits only on an earlier
    # ticket.
    tickets = np.array(
        [
            (p, k)
            for k in range(max(strips, default=0))
            for p in range(len(pairs))
            if k < strips[p]
        ],
        dtype=np.int32,
    ).reshape(-1, 2)
    return CudaGroup(
        seqs=seqs,
        table=table,
        tickets=tickets,
        move_sizes=tuple(
            len(genes[i]) * row_bytes(len(genes[j])) for i, j in pairs
        ),
        aux_len=2 * len(pairs) + hrow_off + strip_base + 1,
        max_len=max(len(genes[i]) + len(genes[j]) for i, j in pairs),
    )


def _cuda_fill(seqs, table, tickets, *, pxy, pgap, move_sizes, aux_len):
    """Penalties and one move buffer per pair, each its own allocation."""
    scores, _, *moves = jax.ffi.ffi_call(
        "nw_fill",
        (
            jax.ShapeDtypeStruct((table.shape[0],), jnp.int32),
            jax.ShapeDtypeStruct((aux_len,), jnp.int32),
            *(jax.ShapeDtypeStruct((b,), jnp.uint8) for b in move_sizes),
        ),
    )(
        seqs, table, tickets,
        pxy=np.int32(pxy), pgap=np.int32(pgap),
        strip_rows=np.int32(STRIP_ROWS),
    )
    return scores, tuple(moves)


def _cuda_walk(table, moves, *, max_len):
    out, counts, _ = jax.ffi.ffi_call(
        "nw_walk",
        (
            jax.ShapeDtypeStruct((table.shape[0], max_len), jnp.int8),
            jax.ShapeDtypeStruct((table.shape[0],), jnp.int32),
            jax.ShapeDtypeStruct((2 * table.shape[0],), jnp.int32),
        ),
    )(table, *moves)
    return out, counts


# Fill and walk are separate programs: the fill's move buffers are then its
# outputs, one allocation each, not one temp buffer the size of the group.
_cuda_fill_jit = jax.jit(
    _cuda_fill, static_argnames=("pxy", "pgap", "move_sizes", "aux_len")
)
_cuda_walk_jit = jax.jit(_cuda_walk, static_argnames=("max_len",))


class _Kernels:
    """One implementation of the group contract.

    ``prepare`` uploads a group's inputs; ``fill`` returns its penalties and
    moves, ``pair_moves`` one pair's (m, row_bytes(n)) uint8 view of them,
    ``walk`` the move streams and their lengths; ``fill_walk``, fill then
    walk, is the production call.

    ``budget`` fixes the bytes a plan may use; None (the default) asks the
    device. Tests on the CPU, whose devices report no memory, set it.
    """

    name = ""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget

    def plan(self, dims, device) -> List[List[int]]:
        budget = self.budget if self.budget is not None else device_budget(
            device
        )
        return plan_groups(dims, budget, self.group_bytes)


@dataclasses.dataclass
class _Prepared:
    genes: Sequence[str]
    pairs: Sequence[Pair]
    host: object
    args: tuple
    max_len: int


class CudaKernels(_Kernels):
    name = "cuda"

    def group_bytes(self, dims) -> int:
        """Device bytes of one group call: inputs, moves, aux and streams."""
        strips = sum(-(-m // STRIP_ROWS) for m, _ in dims)
        moves = sum(_round_up(m * row_bytes(n), _ALIGN) for m, n in dims)
        aux = 4 * (2 * len(dims) + sum(n for _, n in dims) + strips + 1)
        streams = len(dims) * (max(m + n for m, n in dims) + 4)
        inputs = (
            sum(m + n for m, n in dims) + 1 + 4 * TABLE_COLS * len(dims)
            + 8 * strips
        )
        return max(moves, _ALIGN) + aux + streams + 4 * len(dims) + inputs

    def prepare(self, genes, pairs, device) -> _Prepared:
        register_cuda()
        grp = cuda_group(genes, pairs)
        args = jax.device_put((grp.seqs, grp.table, grp.tickets), device)
        return _Prepared(genes, pairs, grp, args, grp.max_len)

    @staticmethod
    def _fill_static(g: _Prepared, pxy, pgap) -> dict:
        return dict(pxy=int(pxy), pgap=int(pgap),
                    move_sizes=g.host.move_sizes, aux_len=g.host.aux_len)

    def fill(self, g: _Prepared, pxy, pgap):
        return _cuda_fill_jit(*g.args, **self._fill_static(g, pxy, pgap))

    def pair_moves(self, g: _Prepared, moves, p):
        i, j = g.pairs[p]
        return moves[p].reshape(len(g.genes[i]), row_bytes(len(g.genes[j])))

    def walk(self, g: _Prepared, moves):
        return _cuda_walk_jit(g.args[1], moves, max_len=g.max_len)

    def fill_walk(self, g: _Prepared, pxy, pgap):
        scores, moves = self.fill(g, pxy, pgap)
        return (scores, *self.walk(g, moves))

    def lower(self, g: _Prepared, pxy, pgap):
        """The fill program, lowered (for ``memory_analysis``)."""
        return _cuda_fill_jit.lower(*g.args, **self._fill_static(g, pxy, pgap))


# --------------------------------------------------------------------------
# Plain JAX twin


def _plain_fill(xc, yc, ms, ns, pxy, pgap):
    """Row scan over a padded group: scores (P,), moves (P, Mp, Np/4)."""
    P, Mp = xc.shape
    Np = yc.shape[1]
    kk = jnp.arange(Np + 1, dtype=jnp.int32)
    col_ok = jnp.arange(Np, dtype=jnp.int32)[None, :] < ns[:, None]
    row0 = jnp.broadcast_to(kk * pgap, (P, Np + 1))  # dp[0][*]

    def step(carry, inp):
        prev, score = carry
        i, xi = inp
        match = xi[:, None] == yc
        cd = prev[:, :-1] + jnp.where(match, 0, pxy)
        cu = prev[:, 1:] + pgap
        # dp[i][j] = min(cd, cu, dp[i][j-1] + pgap) unrolls to a prefix
        # minimum of min(cd, cu) - j*pgap, seeded by dp[i][0] = i*pgap.
        b = jnp.concatenate(
            [jnp.full((P, 1), i * pgap, jnp.int32), jnp.minimum(cd, cu)],
            axis=1,
        )
        cur = jax.lax.cummin(b - kk * pgap, axis=1) + kk * pgap
        c1 = cur[:, 1:]
        code = jnp.where(
            match, 0, jnp.where(cd == c1, 1, jnp.where(cu == c1, 2, 3))
        )
        code = jnp.where(col_ok, code, 0).astype(jnp.uint8).reshape(
            P, Np // 4, 4
        )
        packed = (
            code[..., 0] | (code[..., 1] << 2) | (code[..., 2] << 4)
            | (code[..., 3] << 6)
        )
        hit = jnp.take_along_axis(cur, ns[:, None], axis=1)[:, 0]
        score = jnp.where(ms == i, hit, score)
        return (cur, score), packed

    ii = jnp.arange(1, Mp + 1, dtype=jnp.int32)
    (_, scores), packed = jax.lax.scan(
        step, (row0, jnp.zeros((P,), jnp.int32)), (ii, xc.T)
    )
    return scores, jnp.transpose(packed, (1, 0, 2))


def _plain_walk(moves, ms, ns, *, max_len):
    def one(mv, m, n):
        def cond(s):
            i, j, _, _ = s
            return (i > 0) & (j > 0)

        def body(s):
            i, j, k, out = s
            b = mv[i - 1, (j - 1) // 4]
            v = (b >> (2 * ((j - 1) % 4)).astype(jnp.uint8)) & 3
            out = out.at[k].set(v.astype(jnp.int8))
            return (
                i - (v != 3).astype(jnp.int32),
                j - (v != 2).astype(jnp.int32),
                k + 1,
                out,
            )

        _, _, k, out = jax.lax.while_loop(
            cond, body, (m, n, jnp.int32(0), jnp.zeros((max_len,), jnp.int8))
        )
        return out, k

    return jax.vmap(one)(moves, ms, ns)


_plain_fill_jit = jax.jit(_plain_fill)
_plain_walk_jit = jax.jit(_plain_walk, static_argnames=("max_len",))


@functools.partial(jax.jit, static_argnames=("max_len",))
def _plain_fill_walk(xc, yc, ms, ns, pxy, pgap, *, max_len):
    scores, moves = _plain_fill(xc, yc, ms, ns, pxy, pgap)
    out, counts = _plain_walk(moves, ms, ns, max_len=max_len)
    return scores, out, counts


def _plain_padded(dims):
    mp = _round_up(max(m for m, _ in dims), 16)
    np_ = _round_up(max(n for _, n in dims), 16)
    return mp, np_


def plain_group(genes: Sequence[str], pairs: Sequence[Pair]):
    """Padded codes (x pad -1, y pad -2, never equal) and true lengths."""
    dims = [(len(genes[i]), len(genes[j])) for i, j in pairs]
    mp, np_ = _plain_padded(dims)
    xc = np.full((len(pairs), mp), -1, np.int32)
    yc = np.full((len(pairs), np_), -2, np.int32)
    for p, (i, j) in enumerate(pairs):
        x = np.frombuffer(genes[i].encode("latin-1"), np.uint8)
        y = np.frombuffer(genes[j].encode("latin-1"), np.uint8)
        xc[p, : len(x)] = x
        yc[p, : len(y)] = y
    ms = np.array([d[0] for d in dims], np.int32)
    ns = np.array([d[1] for d in dims], np.int32)
    return xc, yc, ms, ns


class PlainKernels(_Kernels):
    name = "plain"

    def group_bytes(self, dims) -> int:
        mp, np_ = _plain_padded(dims)
        p = len(dims)
        # Scan output, its transpose, the walk's streams and the inputs.
        return p * (2 * mp * (np_ // 4) + (mp + np_) + 8 * (mp + np_ + 1))

    def prepare(self, genes, pairs, device) -> _Prepared:
        host = plain_group(genes, pairs)
        args = jax.device_put(host, device)
        max_len = max(len(genes[i]) + len(genes[j]) for i, j in pairs)
        return _Prepared(genes, pairs, host, args, max_len)

    def fill(self, g: _Prepared, pxy, pgap):
        return _plain_fill_jit(*g.args, np.int32(pxy), np.int32(pgap))

    def pair_moves(self, g: _Prepared, moves, p):
        ms, ns = g.host[2], g.host[3]
        return moves[p, : int(ms[p]), : row_bytes(int(ns[p]))]

    def walk(self, g: _Prepared, moves):
        return _plain_walk_jit(moves, g.args[2], g.args[3], max_len=g.max_len)

    def fill_walk(self, g: _Prepared, pxy, pgap):
        return _plain_fill_walk(
            *g.args, np.int32(pxy), np.int32(pgap), max_len=g.max_len
        )


CUDA = CudaKernels()
PLAIN = PlainKernels()


# --------------------------------------------------------------------------
# Driver


def align_pairs(
    genes: Sequence[str],
    pairs: Sequence[Pair],
    pxy: int,
    pgap: int,
    *,
    kernels=None,
    device=None,
    on_result=None,
) -> List[Tuple[int, str, str]]:
    """Align big pairs on one device; results in the order of ``pairs``.

    ``kernels`` defaults to ``CUDA``, which needs a CUDA GPU; tests pass
    ``PLAIN``. ``on_result(idx, (penalty, a1, a2))`` fires as each pair
    decodes, so a journal keeps finished pairs if a later group fails.
    """
    if kernels is None:
        require_gpu()
        kernels = CUDA
    if device is None:
        device = jax.local_devices()[0]
    dims = [(len(genes[i]), len(genes[j])) for i, j in pairs]
    pending = kernels.plan(dims, device)
    out: List[Optional[Tuple[int, str, str]]] = [None] * len(pairs)
    while pending:
        grp = pending.pop(0)
        gpairs = [pairs[p] for p in grp]
        try:
            prepared = kernels.prepare(genes, gpairs, device)
            scores, streams, counts = jax.device_get(
                kernels.fill_walk(prepared, pxy, pgap)
            )
        except jax.errors.JaxRuntimeError as e:
            # The plan counts free bytes, but the allocator can still refuse
            # a buffer (free memory need not be contiguous); halve the
            # group and go on.
            if "RESOURCE_EXHAUSTED" not in str(e) or len(grp) == 1:
                raise
            from msa_tpu.utils.logging import get_logger

            get_logger("msa_tpu.nw_gpu").warning(
                "group of %d pairs did not fit; splitting it", len(grp)
            )
            half = len(grp) // 2
            pending[:0] = [grp[:half], grp[half:]]
            continue
        for q, p in enumerate(grp):
            i, j = pairs[p]
            a1, a2 = moves_to_alignment(
                genes[i], genes[j], streams[q, : int(counts[q])]
            )
            out[p] = (int(scores[q]), a1, a2)
            if on_result is not None:
                on_result(p, out[p])
    return out  # type: ignore[return-value]
