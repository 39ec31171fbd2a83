// Device code shared by the three persistent decoder kernels
// (decoder_infer.cu, decoder_train_fwd.cu, decoder_train_bwd.cu): one
// cooperative launch each, the time loop inside the kernel, a grid
// barrier between dependent phases (GridBarrier in the decode and the
// forward, cg::grid_group::sync in the reverse chain).  The decode and the
// forward share their product path (product_tile) and their attention
// phases; the reverse chain takes staged_product.
//
// Conventions: weights are in the weight dtype W (float or __nv_bfloat16),
// one contiguous row per output; products round their other operand to W
// and sum in fp32 (the JAX package's "compute-dtype inputs, fp32 sum");
// state that the kernel itself writes is read back through L2 (__ldcg),
// never through the non-coherent read-only path.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 8;  // batch rows per accumulator chunk
constexpr int kCtxCols = 32;
constexpr int kMaxBlocksPerSM = 2;
// dynamic shared memory a block may take on an H100 (227 KB)
constexpr int kSmemLimit = 232448;

template <typename W> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an fp32 value to the weight dtype (the JAX `.astype(cdt)`).
template <typename W> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Store an fp32 value in the weight dtype.
__device__ __forceinline__ void st_w(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_w(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[r][b] += sum_k rnd(x[b*xs + k]) * w[r][k] per lane (partial sums),
// lanes strided over k in 16-byte vectors.  K is a multiple of Vec<W>::N and every row and x
// offset is 16-byte aligned (checked by the Python wrapper).  x is state
// written during the kernel: read through L2 (__ldcg), never the
// non-coherent read-only path.
template <typename W, int R>
__device__ __forceinline__ void warp_dot(float (&acc)[R][kNB],
                                         const W* const* w,
                                         const float* x, int xs, int K,
                                         int nb, int lane) {
  constexpr int V = Vec<W>::N;
  for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
    float wv[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(w[r] + k0));
      const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) wv[r][i] = to_f(e[i]);
    }
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      if (b < nb) {
        float xv[V];
#pragma unroll
        for (int i = 0; i < V; i += 4) {
          float4 q = __ldcg(reinterpret_cast<const float4*>(
              x + (size_t)b * xs + k0 + i));
          xv[i] = rnd<W>(q.x); xv[i + 1] = rnd<W>(q.y);
          xv[i + 2] = rnd<W>(q.z); xv[i + 3] = rnd<W>(q.w);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[r][b] = fmaf(xv[i], wv[r][i], acc[r][b]);
      }
    }
  }
}

// One warp's dot product of a single weight row with up to kNB batch rows
// of x; every lane gets the totals in acc[0][b].
template <typename W>
__device__ __forceinline__ void row_dot(float (&acc)[1][kNB], const W* row,
                                        const float* x, int xs, int K, int nb,
                                        int lane) {
  const W* rows[1] = {row};
  warp_dot<W, 1>(acc, rows, x, xs, K, nb, lane);
}

// ---------------------------------------------------------------------
// Staged skinny product, y[b][i] = sum_k x[b][k] * w[i][k], for a batch of
// a few rows against a tall weight matrix (one row per output, contiguous
// over k).  warp_dot above reads x from L2 once for every weight row; here
// a block stages x once per K-chunk in shared memory beside its own weight
// rows (16-byte cp.async, a kStages-deep ring), so x leaves L2 once a
// block.  x is already in W (rounded once where it was written), so the
// loop rounds nothing.  Each sum is warp_dot's, operation for operation: a
// K-chunk is one 16-byte piece a lane (lane l takes the Vec<W>::N elements
// at l * N of every 32 * N), summed by FMA in k order, then warp_sum; so
// the results are bit for bit those of row_dot on the same values, and do
// not change from run to run.  A warp owns one weight row of a pass; the
// batch goes in passes of kMTile rows.  (Two rows a warp, one pass for a
// block's 16 rows, spilled registers and ran slower in bf16.)
// ---------------------------------------------------------------------
constexpr int kChunkBytes = 512;   // a row's K-chunk: 32 lanes x 16 bytes
constexpr int kStages = 6;
constexpr int kMTile = 16;         // batch rows per pass
constexpr int kMGroup = 4;         // batch rows loaded and summed together
constexpr int kTileRows = kWarps;  // weight rows per pass, one a warp
constexpr int kStageBytes = (kMTile + kTileRows) * kChunkBytes;
constexpr int kProductSmemBytes =
    kStages * kStageBytes + kMTile * kTileRows * (int)sizeof(float);

// 16 bytes global -> shared, skipping L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A W value as fp32 by moving its bits (bf16 is the top half of an fp32):
// the same value as to_f, on the integer pipe instead of the conversion
// unit, which runs at a fraction of its rate.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(x) << 16);
}

// The Vec<W>::N values of a 16-byte piece of shared memory, as fp32.
template <typename W>
__device__ __forceinline__ void load_piece(const char* p,
                                           float (&v)[Vec<W>::N]);
template <>
__device__ __forceinline__ void load_piece<float>(const char* p,
                                                  float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_piece<__nv_bfloat16>(const char* p,
                                                          float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // element 2i is the low half of word i
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The block's product for weight tiles [tile0, tile1) (kTileRows rows
// each, one pass a tile, warp w on row w): every y[b][i] with b < B and i
// in those tiles goes to epi(b, i, y) once, from one thread.  Called by
// the whole block (block-uniform arguments).  x is (B, K) and w (rows, K),
// both in W, row-contiguous, 16-byte aligned, with K a multiple of
// Vec<W>::N (the wrapper checks the widths); smem holds kProductSmemBytes,
// 16-byte aligned.  x is state this kernel wrote: cp.async.cg reads it
// from L2.
template <typename W, typename Epi>
__device__ void staged_product(const W* x, int B, const W* w, int K,
                               int tile0, int tile1, char* smem, Epi epi) {
  constexpr int V = Vec<W>::N;
  constexpr int kPieces = kChunkBytes / 16;   // = 32, one a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_bytes = K * (int)sizeof(W);
  const int n_chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  float* res = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  for (int m0 = 0; m0 < B; m0 += kMTile) {
    const int mrows = min(kMTile, B - m0);
    const char* xg = reinterpret_cast<const char*>(x + (size_t)m0 * K);
    for (int tile = tile0; tile < tile1; ++tile) {
      const char* wg =
          reinterpret_cast<const char*>(w + (size_t)tile * kTileRows * K);
      // chunk ch into its stage: the batch rows, then the weight rows
      auto issue = [&](int ch) {
        if (ch < n_chunks) {
          char* st = smem + (ch % kStages) * kStageBytes;
          const int off = ch * kChunkBytes;
          const int pieces = min(kChunkBytes, row_bytes - off) / 16;
          for (int p = threadIdx.x; p < (kMTile + kTileRows) * kPieces;
               p += kThreads) {
            const int r = p / kPieces, q = p % kPieces;
            if (q >= pieces || (r < kMTile && r >= mrows)) continue;
            const char* src = r < kMTile ? xg + (size_t)r * row_bytes
                                         : wg + (size_t)(r - kMTile) *
                                                    row_bytes;
            cp_async16(st + r * kChunkBytes + q * 16, src + off + q * 16);
          }
        }
        cp_async_commit();   // one group per chunk, empty past the end
      };
      float acc[kMTile];
#pragma unroll
      for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) issue(s);
      for (int ch = 0; ch < n_chunks; ++ch) {
        cp_async_wait<kStages - 2>();   // this thread's copies of chunk ch
        __syncthreads();                // everyone's; stage ch-1 is free
        issue(ch + kStages - 1);
        // lanes past a ragged last chunk add nothing, as in warp_dot
        if (lane * 16 < min(kChunkBytes, row_bytes - ch * kChunkBytes)) {
          const char* st = smem + (ch % kStages) * kStageBytes + lane * 16;
          float wv[V];
          load_piece<W>(st + (kMTile + warp) * kChunkBytes, wv);
          // a group of batch rows at a time, without a branch inside, so
          // their sums interleave; rows of a group past B add into sums
          // that are never read
#pragma unroll
          for (int g = 0; g < kMTile; g += kMGroup) {
            if (g < mrows) {
              float xv[kMGroup][V];
#pragma unroll
              for (int mm = 0; mm < kMGroup; ++mm)
                load_piece<W>(st + (g + mm) * kChunkBytes, xv[mm]);
#pragma unroll
              for (int mm = 0; mm < kMGroup; ++mm)
#pragma unroll
                for (int i = 0; i < V; ++i)
                  acc[g + mm] = fmaf(xv[mm][i], wv[i], acc[g + mm]);
            }
          }
        }
      }
      cp_async_wait<0>();
      // the sums, through shared memory, so that the epilogue's threads
      // take neighbouring weight rows of one batch row
#pragma unroll
      for (int m = 0; m < kMTile; ++m) {
        const float v = warp_sum(acc[m]);
        if (lane == 0) res[m * kTileRows + warp] = v;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < mrows * kTileRows; idx += kThreads)
        epi(m0 + idx / kTileRows, tile * kTileRows + idx % kTileRows,
            res[idx]);
      __syncthreads();   // the ring and res are reused by the next pass
    }
  }
}

// ---------------------------------------------------------------------
// Segmented staged product (the decode kernel and the teacher-forced
// forward).  y[b][i] = sum_s x_s[b] . w[i][seg s] for an operand given as
// up to three segments x_s (B, k_s) in W, row-contiguous, against weight
// rows that are the segments' widths laid end to end.  The wrapper lays
// each weight matrix out tile-major, (tiles, chunks, kWarps * R rows, 32N
// elements), each segment zero-padded to whole chunks and the rows to
// whole tiles, so that a block's chunk of weights is one contiguous
// kWarps * R * 512 bytes: one bulk copy (the Tensor Memory Accelerator's
// 1-D form) by one thread into a ring stage; the batch rows' pieces are
// 16-byte cp.async copies spread over the block.  Both complete the
// stage's mbarrier (every thread arrives through cp.async's own
// arrive-on, the weights' bytes through the barrier's transaction count).
// The batch goes in passes of MT rows (the kernel's batch tile: 8 for the
// decode, 16 for the forward, so that a forward of up to 16 rows copies
// and widens each chunk of weights once a step).  The ring has
// kRingStages<R> stages: 2 of 16 weight rows (the LSTMs), 3 of 8, in
// ring_bytes<MT>().  (Deeper rings ran no faster on an H100: PERF.md.)
// ---------------------------------------------------------------------
__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }

template <int R> constexpr int kRingStages = R == 1 ? 3 : 2;
constexpr int kRingMaxStages = 3;
template <int MT> __host__ __device__ constexpr int ring_bytes() {
  return (2 * (2 * kWarps + MT) > 3 * (kWarps + MT) ? 2 * (2 * kWarps + MT)
                                                    : 3 * (kWarps + MT)) *
         kChunkBytes;
}
template <int MT> __host__ __device__ constexpr int res_bytes() {
  return MT * 2 * kWarps * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes the barrier's current phase waits for, without arriving
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// this thread's arrival, once its cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// global -> shared, `bytes` (a multiple of 16) completing `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename W> struct Operand {
  const W* x[3];
  int k[3];
  int n;
};

// A product: its operand, its tile-major weights (kWarps * R rows a tile)
// and its row count.
template <typename W, int R> struct Product {
  Operand<W> op;
  const W* w;
  int n_rows;
};

// The ring of stages and their barriers; par bit s is the parity that
// stage s's next completion has.  Block-uniform: every thread waits on
// every stage that it reads.
struct Ring {
  char* buf;
  uint64_t* full;
  uint32_t par;
};

// The block's ring barriers, initialised by the whole block at the
// kernel's start.
__device__ __forceinline__ void ring_init(Ring& ring) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRingMaxStages; ++st)
      mbar_init(&ring.full[st], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Chunk ch of an operand whose segments have cs0, cs1 chunks: its segment
// s and its chunk c within it (no dynamic indexing of registers).
__device__ __forceinline__ void locate(int ch, int cs0, int cs1, int& s,
                                       int& c) {
  s = 0;
  c = ch;
  if (c >= cs0) {
    c -= cs0;
    s = 1;
    if (c >= cs1) {
      c -= cs1;
      s = 2;
    }
  }
}

template <typename T>
__device__ __forceinline__ T pick3(int s, T a, T b, T c) {
  return s == 0 ? a : (s == 1 ? b : c);
}

// A product's chunk walk: per-segment widths and chunk counts.
template <typename W, int R, int MT> struct Walk {
  static constexpr int V = Vec<W>::N;
  static constexpr int CE = 32 * V;          // elements of a chunk
  static constexpr int TR = kWarps * R;      // weight rows of a tile
  static constexpr uint32_t kWBytes = TR * kChunkBytes;
  static constexpr int kStageBytes = (TR + MT) * kChunkBytes;
  static constexpr int kStages = kRingStages<R>;
  static_assert(kStages * kStageBytes <= ring_bytes<MT>(), "ring");
  int k0, k1, k2, cs0, cs1, n;
  __device__ explicit Walk(const Operand<W>& op)
      : k0(op.k[0]), k1(op.n > 1 ? op.k[1] : 0), k2(op.n > 2 ? op.k[2] : 0),
        cs0((k0 + CE - 1) / CE), cs1((k1 + CE - 1) / CE),
        n(cs0 + cs1 + (k2 + CE - 1) / CE) {}
  // chunk ch's segment width, its first element in the segment
  __device__ void at(int ch, int& ks, int& e0, int& s) const {
    int c;
    locate(ch, cs0, cs1, s, c);
    ks = pick3(s, k0, k1, k2);
    e0 = c * CE;
  }
};

// The FMAs of batch rows m0 .. m0 + G - 1 of a chunk, loaded and summed
// together so that their sums interleave: acc[r][m] += x[m] . w[r] over the
// lane's piece, in element order.  row_group takes the rows G0 .. G0 +
// kMGroup - 1: in bf16 those that there are (mrows), so that no row past B
// is summed; in fp32 all four once one is (rows past B add into sums that
// are never read), which ran faster there on an H100 (PERF.md).
template <typename W, int R, int MT, int G, int m0>
__device__ __forceinline__ void fma_rows(float (&acc)[R][MT],
                                         const float (&wv)[R][Vec<W>::N],
                                         const char* xp) {
  constexpr int V = Vec<W>::N;
  float xv[G][V];
#pragma unroll
  for (int mm = 0; mm < G; ++mm)
    load_piece<W>(xp + (m0 + mm) * kChunkBytes, xv[mm]);
#pragma unroll
  for (int mm = 0; mm < G; ++mm)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[r][m0 + mm] = fmaf(xv[mm][i], wv[r][i], acc[r][m0 + mm]);
}

template <typename W, int R, int MT, int G0>
__device__ __forceinline__ void row_group(float (&acc)[R][MT],
                                          const float (&wv)[R][Vec<W>::N],
                                          const char* xp, int mrows) {
  static_assert(kMGroup == 4 && G0 + kMGroup <= MT, "row groups");
  const int left = mrows - G0;
  if constexpr (sizeof(W) == 4) {
    if (left > 0) fma_rows<W, R, MT, 4, G0>(acc, wv, xp);
  } else if (left >= 4)
    fma_rows<W, R, MT, 4, G0>(acc, wv, xp);
  else if (left == 3)
    fma_rows<W, R, MT, 3, G0>(acc, wv, xp);
  else if (left == 2)
    fma_rows<W, R, MT, 2, G0>(acc, wv, xp);
  else if (left == 1)
    fma_rows<W, R, MT, 1, G0>(acc, wv, xp);
}

// Every row group of a pass, G0 = 0, kMGroup, ... < MT.
template <typename W, int R, int MT, int G0 = 0>
__device__ __forceinline__ void row_groups(float (&acc)[R][MT],
                                           const float (&wv)[R][Vec<W>::N],
                                           const char* xp, int mrows) {
  row_group<W, R, MT, G0>(acc, wv, xp, mrows);
  if constexpr (G0 + kMGroup < MT)
    row_groups<W, R, MT, G0 + kMGroup>(acc, wv, xp, mrows);
}

// Thread 0: tile's weights of chunk ch into stage st.
template <typename W, int R, int MT>
__device__ __forceinline__ void issue_weights(const Product<W, R>& pr,
                                              const Walk<W, R, MT>& wk,
                                              int tile, int ch, int st,
                                              Ring& ring) {
  mbar_expect(&ring.full[st], wk.kWBytes);
  bulk_copy(ring.buf + st * wk.kStageBytes,
            pr.w + (size_t)(tile * wk.n + ch) * wk.TR * wk.CE, wk.kWBytes,
            &ring.full[st]);
}

// Every thread: its pieces of batch rows m0 .. m0 + mrows - 1 of chunk ch
// into stage st, then its arrival on the stage once they have landed.
template <typename W, int R, int MT>
__device__ __forceinline__ void issue_x(const Product<W, R>& pr,
                                        const Walk<W, R, MT>& wk, int ch,
                                        int m0, int mrows, int st,
                                        Ring& ring) {
  int ks, e0, s;
  wk.at(ch, ks, e0, s);
  const W* xs = pick3(s, pr.op.x[0], pr.op.x[1], pr.op.x[2]) +
                (size_t)m0 * ks + e0;
  const int pieces = min(wk.CE, ks - e0) / wk.V;
  char* dst = ring.buf + st * wk.kStageBytes + wk.TR * kChunkBytes;
  for (int p = threadIdx.x; p < mrows * 32; p += kThreads) {
    const int m = p >> 5, q = p & 31;
    if (q < pieces)
      cp_async16(dst + m * kChunkBytes + q * 16,
                 xs + (size_t)m * ks + q * wk.V);
  }
  mbar_arrive_after_copies(&ring.full[st]);
}

// Before a grid barrier: the first chunks of weights of tile `tile` of the
// next product, which depend on nothing the barrier orders.  Returns
// whether it issued them (block-uniform).
template <int MT, typename W, int R>
__device__ bool prefetch_tile(const Product<W, R>& pr, Ring& ring,
                              int tile) {
  const Walk<W, R, MT> wk(pr.op);
  if (tile < 0 || tile >= (pr.n_rows + wk.TR - 1) / wk.TR) return false;
  if (threadIdx.x == 0)
    for (int ch = 0; ch < min(wk.kStages - 1, wk.n); ++ch)
      issue_weights(pr, wk, tile, ch, ch, ring);
  return true;
}

// The same for the block's first tile of the product.
template <int MT, typename W, int R>
__device__ __forceinline__ bool prefetch(const Product<W, R>& pr,
                                         Ring& ring) {
  return prefetch_tile<MT>(pr, ring, blockIdx.x);
}

// A prefetch that no product takes (the decode stopped): let its stages
// complete before the block exits.
template <int MT, typename W, int R>
__device__ void drain(const Product<W, R>& pr, Ring& ring) {
  const Walk<W, R, MT> wk(pr.op);
  const int n = min(wk.kStages - 1, wk.n);
  for (int st = 0; st < n; ++st) mbar_arrive(&ring.full[st]);
  for (int st = 0; st < n; ++st) {
    mbar_wait(&ring.full[st], (ring.par >> st) & 1u);
    ring.par ^= 1u << st;
  }
}

// The block's product for weight rows [tile * kWarps * R, + kWarps * R)
// (warp w on rows w * R .. w * R + R - 1 of the tile), all B batch rows in
// passes of MT; after each pass the sums are in res[m * kWarps * R + row
// in tile] and epi(m0, mrows, row0, res) runs on the whole block.  Called
// by the whole block; `prefetched`: prefetch() issued this tile's first
// weights.  Each sum is warp_dot's over the segments in order: chunk c of
// segment s is elements [c * 32N, (c + 1) * 32N) of it, lane l its N
// elements at l * N (lanes past a ragged end add nothing), FMA in k order;
// then warp_sum.  Every k_s is a multiple of N and every pointer 16-byte
// aligned (the wrapper checks the widths).  x is state that this kernel
// wrote before the last grid barrier: cp.async.cg reads it from L2.
template <int MT, typename W, int R, typename Epi>
__device__ void product_tile(const Product<W, R>& pr, int B, int tile,
                             bool prefetched, Ring& ring, float* res,
                             Epi epi) {
  constexpr int V = Vec<W>::N;
  const Walk<W, R, MT> wk(pr.op);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * wk.TR;
  for (int m0 = 0; m0 < B; m0 += MT) {
    const int mrows = min(MT, B - m0);
    const bool pre = prefetched && m0 == 0;
    // chunk ch, weights and batch rows, into stage ch % kStages
    auto issue = [&](int ch, bool weights) {
      const int st = ch % wk.kStages;
      if (weights && threadIdx.x == 0)
        issue_weights(pr, wk, tile, ch, st, ring);
      issue_x(pr, wk, ch, m0, mrows, st, ring);
    };
    for (int ch = 0; ch < min(wk.kStages - 1, wk.n); ++ch) issue(ch, !pre);
    float acc[R][MT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
    for (int ch = 0; ch < wk.n; ++ch) {
      if (ch > 0) __syncthreads();      // stage (ch - 1) % kStages is free
      if (ch + wk.kStages - 1 < wk.n) issue(ch + wk.kStages - 1, true);
      const int st = ch % wk.kStages;
      mbar_wait(&ring.full[st], (ring.par >> st) & 1u);
      ring.par ^= 1u << st;
      int ks, e0, s;
      wk.at(ch, ks, e0, s);
      if (lane * V < ks - e0) {
        const char* sp = ring.buf + st * wk.kStageBytes + lane * 16;
        float wv[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r)
          load_piece<W>(sp + (warp * R + r) * kChunkBytes, wv[r]);
        row_groups<W, R, MT>(acc, wv, sp + wk.TR * kChunkBytes, mrows);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mrows) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = warp_sum(acc[r][m]);
          if (lane == 0) res[m * wk.TR + warp * R + r] = v;
        }
      }
    }
    __syncthreads();
    epi(m0, mrows, row0, static_cast<const float*>(res));
    __syncthreads();   // the ring and res are reused by the next pass
  }
}

// Every tile of a product, tiles dealt over `count` blocks from block
// `first` on (count 0: the whole grid): block first + i takes tile i, i +
// count, ...; blocks outside take none.
template <int MT, typename W, int R, typename Epi>
__device__ __forceinline__ void product_phase(const Product<W, R>& pr, int B,
                                              bool prefetched, Ring& ring,
                                              float* res, Epi epi,
                                              int first = 0, int count = 0) {
  const int n_tiles = (pr.n_rows + kWarps * R - 1) / (kWarps * R);
  const int grid = gridDim.x, step = count > 0 ? count : grid;
  const int mine = ((int)blockIdx.x - first + grid) % grid;
  if (mine >= step) return;
  for (int tile = mine; tile < n_tiles; tile += step)
    product_tile<MT>(pr, B, tile, prefetched && tile == mine, ring, res,
                     epi);
}

// out[b][j] = x[b] . w[j] (+ bias[j] where bias is not null) for j <
// n_rows (RELU: clamped at 0), in O at out + b * ldo + j; tiles dealt as
// product_phase deals them.
template <int MT, bool RELU, typename W, typename O>
__device__ void matvec_phase(const Product<W, 1>& pr, O* out, int ldo,
                             const float* bias, int B, bool prefetched,
                             Ring& ring, float* res, int first = 0,
                             int count = 0) {
  const int n_out = pr.n_rows;
  product_phase<MT>(pr, B, prefetched, ring, res,
                    [&](int m0, int mrows, int row0, const float* sums) {
    for (int idx = threadIdx.x; idx < mrows * kWarps; idx += kThreads) {
      const int m = idx / kWarps, j = row0 + idx % kWarps;
      if (j < n_out) {
        float y = sums[m * kWarps + idx % kWarps];
        if (bias) y += bias[j];
        st_w(out + (size_t)(m0 + m) * ldo + j, RELU ? fmaxf(y, 0.f) : y);
      }
    }
  }, first, count);
}

// Block-wide reduction; every thread gets the result.
__device__ inline float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : (is_max ? -INFINITY : 0.f);
    v = is_max ? warp_max(v) : warp_sum(v);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  v = red[kWarps];
  __syncthreads();
  return v;
}

// Softmax over T and context, one block per (b, kCtxCols-column chunk of
// E): attn = softmax(energy[b]); prev = attn; cum += attn; ctx[b] = attn .
// mem[b] (W memory, fp32 sum), stored as C (fp32, or W where every reader
// rounds it to W anyway).  attn_out, where not null, receives the row at
// attn_out + b * attn_stride.  Shared memory: red (kWarps + 1), ctx_red
// (kWarps * kCtxCols), attn_s (T).
template <typename W, typename C = float>
__device__ inline void softmax_context_phase(const float* energy, const W* mem,
                                             float* prev, float* cum,
                                             C* ctx, float* attn_out,
                                             size_t attn_stride, float* red,
                                             float* ctx_red, float* attn_s,
                                             int B, int T, int E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (E + kCtxCols - 1) / kCtxCols;
  for (int task = blockIdx.x; task < B * n_chunks; task += gridDim.x) {
    const int b = task / n_chunks, ch = task % n_chunks;
    const float* eb = energy + (size_t)b * T;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < T; i += kThreads)
      m = fmaxf(m, __ldcg(eb + i));
    m = block_reduce(m, red, true);
    float s = 0.f;
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const float w = expf(__ldcg(eb + i) - m);
      attn_s[i] = w;
      s += w;
    }
    s = block_reduce(s, red, false);
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const float w = attn_s[i] / s;
      attn_s[i] = w;
      if (ch == 0) {
        const size_t o = (size_t)b * T + i;
        prev[o] = w;
        cum[o] = __ldcg(cum + o) + w;
        if (attn_out) attn_out[(size_t)b * attn_stride + i] = w;
      }
    }
    __syncthreads();
    const int d = ch * kCtxCols + lane;
    float acc = 0.f;
    if (d < E)
      for (int i = warp; i < T; i += kWarps)
        acc = fmaf(attn_s[i], to_f(mem[((size_t)b * T + i) * E + d]), acc);
    ctx_red[warp * kCtxCols + lane] = acc;
    __syncthreads();
    if (warp == 0 && d < E) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += ctx_red[w * kCtxCols + lane];
      st_w(ctx + (size_t)b * E + d, sum);
    }
    __syncthreads();
  }
}

// Location-sensitive energies, one warp per (b, t_enc):
//   q = rnd(pq[b] + pm[b, t] + [prev | cum] window . wloc)
//   energy[b, t] = mask ? -1e9 : (tanh(q) . v + v_b) * escale
// wl: the composed (2K, A) matrix in shared memory; a lane sums its
// columns j = lane + 32q four at a time, each over the window in tap
// order, and tanh(q) . v in column order.  qsum_out, where not null,
// receives q in W as (B, T, A), written once and coalesced over A.
// win_all: kWarps * 2K floats of shared memory.
// (Inlined at each call site: where a kernel passes its shared-memory
// copy of wl the loads are shared-memory loads, as where it passes the L2
// one they are global loads.)
template <typename W>
__device__ __forceinline__ void energies_resident(const W* wl,
                                                  const float* prev,
                                  const float* cum, const float* pq,
                                  const float* pm, const float* v,
                                  const uint8_t* mask, float v_b,
                                  float escale, float* energy, W* qsum_out,
                                  float* win_all,
                                  int B, int T, int A, int K, int gw, int nw,
                                  int lane, int warp) {
  const int pad = (K - 1) / 2;
  float* win = win_all + warp * 2 * K;
  for (int idx = gw; idx < B * T; idx += nw) {
    const int b = idx / T, tt = idx % T;
    for (int i = lane; i < 2 * K; i += 32) {
      const int c = i / K, k = i % K, src = tt + k - pad;
      const float* in = c == 0 ? prev : cum;
      win[i] = (src >= 0 && src < T)
                   ? rnd<W>(__ldcg(in + (size_t)b * T + src)) : 0.f;
    }
    __syncwarp();
    float e = 0.f;
    for (int j0 = lane; j0 < A; j0 += 4 * 32) {
      float loc[4] = {0.f, 0.f, 0.f, 0.f};
      float base[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q;
        base[q] = j < A ? __ldcg(pq + (size_t)b * A + j) +
                              pm[((size_t)b * T + tt) * A + j]
                        : 0.f;
      }
      for (int i = 0; i < 2 * K; ++i) {
        const float x = win[i];
        const W* row = wl + (size_t)i * A + j0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + 32 * q < A) loc[q] = fmaf(x, to_f(row[32 * q]), loc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q;
        if (j < A) {
          const float qv = rnd<W>(base[q] + loc[q]);
          if (qsum_out) st_w(qsum_out + ((size_t)b * T + tt) * A + j, qv);
          e = fmaf(tanhf(qv), v[j], e);
        }
      }
    }
    e = warp_sum(e);
    if (lane == 0) {
      e = (e + v_b) * escale;
      energy[(size_t)b * T + tt] = mask[(size_t)b * T + tt] ? -1e9f : e;
    }
    __syncwarp();
  }
}

// The grid barrier: every block's thread 0 adds one to a counter that only
// grows (zeroed by the caller) with release semantics, after the block's
// __syncthreads, and waits with acquire loads until it holds gridDim.x
// arrivals for every barrier so far; then the block's __syncthreads.  The
// cooperative launch keeps every block resident.  (cg::grid_group::sync
// fences with __threadfence on both sides; release and acquire are enough
// here, and cost less: PERF.md has the times.)
struct GridBarrier {
  unsigned int* count;
  unsigned int n, target;
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += n;
      unsigned int old, cur;
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(count)
                   : "memory");
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(cur)
                     : "l"(count)
                     : "memory");
      } while ((int)(cur - target) < 0);
    }
    __syncthreads();
  }
};

// Cooperative launch of `kern(const Args)` on `stream`: the grid is the
// kernel's occupancy (at most kMaxBlocksPerSM blocks per SM) times the SM
// count, written to *grid_blocks.  Returns a cudaError_t (0 = launched).
template <typename Args>
static int coop_launch(void (*kern)(const Args), Args* a, size_t smem,
                       int device, cudaStream_t stream, int* grid_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_blocks = std::min(per_sm, kMaxBlocksPerSM) * sms;
  void* args[] = {a};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(*grid_blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
