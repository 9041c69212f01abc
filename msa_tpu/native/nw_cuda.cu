// Needleman-Wunsch fill and traceback walk for a group of pairs, as XLA FFI
// handlers for NVIDIA Hopper (build: msa_tpu/native/build.py).
//
// Contract (shared with the plain-JAX twin in msa_tpu/ops/nw_gpu.py):
//
//   table  int32 [P, 8]  per pair: x_off, y_off, m, n, hrow_off,
//                        strip_base, 0, 0
//   moves  one buffer per pair (separate allocations, so a fragmented
//          allocator still places them), 2-bit codes, row-major: row i-1
//          (i = 1..m) holds
//          ceil(n/16) little-endian uint32 words; cell (i, j) sits at bits
//          2*((j-1)%16) of word (j-1)/16. Bits past column n are zero.
//          Codes: 0 match, 1 substitution, 2 up, 3 left, chosen in the
//          reference's tie-break order match > diag > up > left.
//
// Fill: one warp owns a strip of kStripRows rows of one pair (each lane
// kRowsPerLane consecutive rows) and sweeps it left to right as a skewed
// wavefront: lane l works on column s-l at step s, the row above arrives
// from lane l-1 by __shfl_up_sync, and the lane's rows stay in registers.
// Moves are staged in shared memory and leave in 16-byte row segments once
// every lane has finished them (one 4-byte store per lane per 16 columns
// straight to global memory took over half the fill's time). The strip's
// bottom row goes to a per-pair row buffer in global memory;
// the strip below waits on a per-strip progress flag before reading it.
// Strips are handed out by an atomic ticket in an order that keeps each
// pair's strips in sequence, so a strip only ever waits on a strip that a
// running block already holds: no deadlock, whatever order the hardware
// schedules blocks in.
//
// Walk: one warp per pair caches a 32-row x 32-column window of moves in
// registers (one row per lane) and steps through it with shuffles, so a
// global load round trip is paid once per window instead of once per move.

#include <cstdint>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerLane = 8;
constexpr int kStripRows = kLanes * kRowsPerLane;
constexpr int kPublishEvery = 32;  // columns between progress flag updates
// Move words (16 columns each) staged per row before a flush; two slots, as
// lane 0 runs kLanes-1 columns ahead of lane 31.
constexpr int kFlushWords = 4;
constexpr int kFlushCols = kFlushWords * 16;
static_assert(kFlushCols >= kLanes, "a slot must outlast the lanes' skew");
constexpr unsigned kFull = 0xffffffffu;

struct PairRow {
  int x_off, y_off, m, n, hrow_off, strip_base, unused0, unused1;
};
static_assert(sizeof(PairRow) == 8 * sizeof(int), "table row is 8 int32");

__global__ void __launch_bounds__(kLanes)
    nw_fill_kernel(const uint8_t* __restrict__ seqs,
                   const PairRow* __restrict__ table,
                   const int2* __restrict__ tickets, int num_strips, int pxy,
                   int pgap, int* __restrict__ scores,
                   uint8_t* const* __restrict__ move_ptrs,
                   int* __restrict__ hrow_all,
                   int* __restrict__ progress, int* __restrict__ counter) {
  const int lane = threadIdx.x;
  int t = 0;
  if (lane == 0) t = atomicAdd(counter, 1);
  t = __shfl_sync(kFull, t, 0);
  if (t >= num_strips) return;

  const int2 tk = tickets[t];  // (pair, strip within pair)
  const PairRow pr = table[tk.x];
  const int k = tk.y;
  const int m = pr.m, n = pr.n;
  const uint8_t* __restrict__ x = seqs + pr.x_off;
  const uint8_t* __restrict__ y = seqs + pr.y_off;
  int* hrow = hrow_all + pr.hrow_off;
  const int g = pr.strip_base + k;
  const bool first = (k == 0);
  const bool has_next = (k + 1) * kStripRows < m;
  const size_t words = (size_t)((n + 15) >> 4);
  uint32_t* mv = reinterpret_cast<uint32_t*>(move_ptrs[tk.x]);
  const int strip_row0 = k * kStripRows + 1;
  const int row0 = strip_row0 + lane * kRowsPerLane;
  __shared__ uint32_t stage[2][kStripRows][kFlushWords];

  int xc[kRowsPerLane];
  int left[kRowsPerLane];
  uint32_t acc[kRowsPerLane];
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    const int r = row0 + q;
    xc[q] = r <= m ? (int)x[r - 1] : -1;  // -1 never matches a y byte
    left[q] = r * pgap;                    // dp[r][0]
    acc[q] = 0u;
  }
  int top_prev = (row0 - 1) * pgap;  // dp[row0-1][j-1]
  int bottom = 0;
  int avail = 0;

  const int steps = n + kLanes - 1;
  for (int s = 0; s < steps; ++s) {
    const int j = s - lane + 1;
    int above = __shfl_up_sync(kFull, bottom, 1);
    const bool active = j >= 1 && j <= n;
    if (lane == 0 && active) {
      if (first) {
        above = j * pgap;
      } else {
        if (avail < j) {
          const volatile int* flag = progress + g - 1;
          do {
            avail = *flag;
          } while (avail < j);
          __threadfence();
        }
        above = __ldcg(hrow + j - 1);
      }
    }
    if (active) {
      const int yc = (int)y[j - 1];
      const int sh = 2 * ((j - 1) & 15);
      int up = above;
      int diag = top_prev;
#pragma unroll
      for (int q = 0; q < kRowsPerLane; ++q) {
        const bool match = xc[q] == yc;
        const int cd = diag + (match ? 0 : pxy);
        const int cu = up + pgap;
        const int cur = __vimin3_s32(cd, cu, left[q] + pgap);
        const uint32_t code =
            match ? 0u : (cd == cur ? 1u : (cu == cur ? 2u : 3u));
        acc[q] |= code << sh;
        diag = left[q];
        up = cur;
        left[q] = cur;
      }
      top_prev = above;
      bottom = up;
      if (sh == 30 || j == n) {
        const int w = (j - 1) >> 4;
        uint32_t(*slot)[kFlushWords] = stage[(w / kFlushWords) & 1];
#pragma unroll
        for (int q = 0; q < kRowsPerLane; ++q) {
          slot[lane * kRowsPerLane + q][w % kFlushWords] = acc[q];
          acc[q] = 0u;
        }
      }
      if (lane == kLanes - 1 && has_next) {
        __stcg(hrow + j - 1, bottom);
        if (j % kPublishEvery == 0 || j == n) {
          __threadfence();
          atomicExch(progress + g, j);
        }
      }
    }
    // Lane 31 has just finished column jl: once that closes a slot, every
    // lane has, and the warp writes the slot out row segment by segment.
    const int jl = s - (kLanes - 1) + 1;
    if (jl >= 1 && (jl % kFlushCols == 0 || jl == n)) {
      __syncwarp();
      const int grp = (jl - 1) / kFlushCols;
      const uint32_t(*slot)[kFlushWords] = stage[grp & 1];
      const int w0 = grp * kFlushWords;
      const int nw = min(kFlushWords, (int)words - w0);
      for (int idx = lane; idx < kStripRows * kFlushWords; idx += kLanes) {
        const int rr = idx / kFlushWords;
        const int w = idx % kFlushWords;
        const int r = strip_row0 + rr;
        if (r <= m && w < nw) mv[(size_t)(r - 1) * words + w0 + w] = slot[rr][w];
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    if (row0 + q == m) scores[tk.x] = left[q];
  }
}

__global__ void __launch_bounds__(kLanes)
    nw_walk_kernel(const uint8_t* const* __restrict__ move_ptrs,
                   const PairRow* __restrict__ table,
                   int8_t* __restrict__ out, int* __restrict__ counts,
                   int64_t out_stride) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const PairRow pr = table[p];
  const size_t words = (size_t)((pr.n + 15) >> 4);
  const uint32_t* mv = reinterpret_cast<const uint32_t*>(move_ptrs[p]);
  int8_t* o = out + (size_t)p * out_stride;
  int i = pr.m, j = pr.n, k = 0;
  while (i > 0 && j > 0) {
    // Window: rows i-31..i (lane L holds row i-31+L), columns of words
    // wh-1 and wh, where wh holds column j.
    const int wh = (j - 1) >> 4;
    const int rtop = i - (kLanes - 1);
    const int r = rtop + lane;
    uint32_t hi = 0u, lo = 0u;
    if (r >= 1) {
      const uint32_t* row = mv + (size_t)(r - 1) * words;
      hi = __ldg(row + wh);
      if (wh > 0) lo = __ldg(row + wh - 1);
    }
    const int cbase = (wh - 1) * 16;  // 0-based column of lo's bit 0
    while (i > 0 && j > 0 && i >= rtop && j - 1 >= cbase) {
      const int src = i - rtop;
      const uint32_t h = __shfl_sync(kFull, hi, src);
      const uint32_t l = __shfl_sync(kFull, lo, src);
      const int c = j - 1 - cbase;
      const uint32_t v = (c >= 16 ? (h >> (2 * (c - 16))) : (l >> (2 * c))) & 3u;
      if (lane == 0) o[k] = (int8_t)v;
      ++k;
      if (v != 3u) --i;
      if (v != 2u) --j;
    }
  }
  if (lane == 0) counts[p] = k;
}

// Kernels launch on the card that owns XLA's buffers, which need not be the
// calling thread's current device when one process drives several cards.
ffi::Error use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("cudaPointerGetAttributes: ") +
                                cudaGetErrorString(err));
  }
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != attr.device) {
    err = cudaSetDevice(attr.device);
    if (err != cudaSuccess) {
      return ffi::Error::Internal(std::string("cudaSetDevice: ") +
                                  cudaGetErrorString(err));
    }
  }
  return ffi::Error::Success();
}

ffi::Error launch_status(const char* what) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

// Copies the per-pair move buffer addresses into device memory at `dst`.
// From pageable host memory cudaMemcpyAsync stages the bytes before it
// returns, so the vector may go out of scope right after.
ffi::Error upload_pointers(const std::vector<uint8_t*>& ptrs, void* dst,
                           cudaStream_t stream) {
  if (ptrs.empty()) return ffi::Error::Success();
  cudaError_t err =
      cudaMemcpyAsync(dst, ptrs.data(), ptrs.size() * sizeof(uint8_t*),
                      cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("pointer upload: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error FillImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> seqs,
                    ffi::Buffer<ffi::S32> table, ffi::Buffer<ffi::S32> tickets,
                    ffi::ResultBuffer<ffi::S32> scores,
                    ffi::ResultBuffer<ffi::S32> aux, ffi::RemainingRets moves,
                    int32_t pxy, int32_t pgap, int32_t strip_rows) {
  if (strip_rows != kStripRows) {
    return ffi::Error::InvalidArgument(
        "nw_fill: strip_rows " + std::to_string(strip_rows) +
        " != compiled " + std::to_string(kStripRows));
  }
  const auto tdims = table.dimensions();
  const auto kdims = tickets.dimensions();
  if (tdims.size() != 2 || tdims[1] != 8 || kdims.size() != 2 ||
      kdims[1] != 2 || (int64_t)moves.size() != tdims[0]) {
    return ffi::Error::InvalidArgument("nw_fill: bad table/tickets/moves");
  }
  const int64_t num_pairs = tdims[0];
  const int64_t num_strips = kdims[0];
  const int64_t aux_len = aux->element_count();
  if (aux_len < 2 * num_pairs + num_strips + 1) {
    return ffi::Error::InvalidArgument("nw_fill: aux buffer too small");
  }
  std::vector<uint8_t*> ptrs(num_pairs);
  for (int64_t p = 0; p < num_pairs; ++p) {
    auto buf = moves.get<ffi::Buffer<ffi::U8>>(p);
    if (buf.has_error()) return buf.error();
    ptrs[p] = (*buf)->typed_data();
  }
  if (ffi::Error e = use_device_of(aux->untyped_data()); e.failure()) {
    return e;
  }
  // aux layout: [move pointers (2 int32 each) | row buffers |
  //              progress flags (num_strips) | ticket counter]
  int* aux_p = aux->typed_data();
  int* progress = aux_p + (aux_len - num_strips - 1);
  int* counter = aux_p + (aux_len - 1);
  if (ffi::Error e = upload_pointers(ptrs, aux_p, stream); e.failure()) {
    return e;
  }
  cudaMemsetAsync(progress, 0, (num_strips + 1) * sizeof(int), stream);
  if (num_strips > 0) {
    nw_fill_kernel<<<(unsigned)num_strips, kLanes, 0, stream>>>(
        seqs.typed_data(),
        reinterpret_cast<const PairRow*>(table.typed_data()),
        reinterpret_cast<const int2*>(tickets.typed_data()), (int)num_strips,
        pxy, pgap, scores->typed_data(),
        reinterpret_cast<uint8_t* const*>(aux_p), aux_p + 2 * num_pairs,
        progress, counter);
  }
  return launch_status("nw_fill");
}

ffi::Error WalkImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> table,
                    ffi::RemainingArgs moves, ffi::ResultBuffer<ffi::S8> out,
                    ffi::ResultBuffer<ffi::S32> counts,
                    ffi::ResultBuffer<ffi::S32> scratch) {
  const auto tdims = table.dimensions();
  const auto odims = out->dimensions();
  if (tdims.size() != 2 || tdims[1] != 8 || odims.size() != 2 ||
      odims[0] != tdims[0] || (int64_t)moves.size() != tdims[0] ||
      scratch->element_count() < 2 * (size_t)tdims[0]) {
    return ffi::Error::InvalidArgument("nw_walk: bad table/moves/out shape");
  }
  const int64_t num_pairs = tdims[0];
  std::vector<uint8_t*> ptrs(num_pairs);
  for (int64_t p = 0; p < num_pairs; ++p) {
    auto buf = moves.get<ffi::Buffer<ffi::U8>>(p);
    if (buf.has_error()) return buf.error();
    ptrs[p] = buf->typed_data();
  }
  if (ffi::Error e = use_device_of(out->untyped_data()); e.failure()) {
    return e;
  }
  void* table_p = scratch->untyped_data();
  if (ffi::Error e = upload_pointers(ptrs, table_p, stream); e.failure()) {
    return e;
  }
  if (num_pairs > 0) {
    nw_walk_kernel<<<(unsigned)num_pairs, kLanes, 0, stream>>>(
        reinterpret_cast<const uint8_t* const*>(table_p),
        reinterpret_cast<const PairRow*>(table.typed_data()),
        out->typed_data(), counts->typed_data(), odims[1]);
  }
  return launch_status("nw_walk");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(NwFill, FillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .RemainingRets()
                                  .Attr<int32_t>("pxy")
                                  .Attr<int32_t>("pgap")
                                  .Attr<int32_t>("strip_rows"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(NwWalk, WalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .RemainingArgs()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
