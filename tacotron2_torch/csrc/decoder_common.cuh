// Device code shared by the three persistent decoder kernels
// (decoder_infer.cu, decoder_train_fwd.cu, decoder_train_bwd.cu): one
// cooperative launch each, the time loop inside the kernel, grid.sync()
// between dependent phases.
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

// Load a weight-dtype value that this kernel wrote, through L2.
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
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

// Sum each lane's partial dot products over the warp (after the last
// warp_dot into acc); every lane gets the totals.
template <int R>
__device__ __forceinline__ void warp_reduce(float (&acc)[R][kNB]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < kNB; ++b) acc[r][b] = warp_sum(acc[r][b]);
}

// Lane b's column of the reduced accumulators: out[r] = acc[r][lane]
// (lane < kNB), without dynamic indexing of registers.
template <int R>
__device__ __forceinline__ void pick_row(const float (&acc)[R][kNB], int lane,
                                         float (&out)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.f;
#pragma unroll
  for (int b = 0; b < kNB; ++b)
    if (b == lane)
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] = acc[r][b];
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

// Pre-activation LSTM gates of hidden unit j for batch rows b0..b0+nb-1:
// acc[g][b] = [x1 | x2][b] . wi[g*H + j] + h_old[b] . wh[g*H + j], gate
// order i, f, g, o, reduced over the warp (no bias).
template <typename W>
__device__ __forceinline__ void lstm_gates(float (&acc)[4][kNB], const W* wi,
                                           const W* wh, const float* x1,
                                           int k1, const float* x2, int k2,
                                           const float* h_old, int H, int j,
                                           int b0, int nb, int lane) {
  const int kin = k1 + k2;
  const W* r1[4];
  const W* r2[4];
  const W* rh[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    r1[g] = wi + (size_t)(g * H + j) * kin;
    r2[g] = r1[g] + k1;
    rh[g] = wh + (size_t)(g * H + j) * H;
  }
  warp_dot<W, 4>(acc, r1, x1 + (size_t)b0 * k1, k1, k1, nb, lane);
  warp_dot<W, 4>(acc, r2, x2 + (size_t)b0 * k2, k2, k2, nb, lane);
  warp_dot<W, 4>(acc, rh, h_old + (size_t)b0 * H, H, H, nb, lane);
  warp_reduce<4>(acc);
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

// out[b][j] = rnd(x[b]) . w[j] for j < n_out (RELU: clamped at 0): one
// warp per j.
template <typename W, bool RELU>
__device__ inline void matvec(const W* w, const float* x, float* out, int K,
                              int n_out, int B, int gw, int nw, int lane) {
  for (int j = gw; j < n_out; j += nw) {
    for (int b0 = 0; b0 < B; b0 += kNB) {
      const int nb = min(kNB, B - b0);
      float acc[1][kNB] = {};
      row_dot<W>(acc, w + (size_t)j * K, x + (size_t)b0 * K, K, K, nb, lane);
      warp_reduce<1>(acc);
      if (lane == 0)
        for (int b = 0; b < nb; ++b)
          out[(size_t)(b0 + b) * n_out + j] =
              RELU ? fmaxf(acc[0][b], 0.f) : acc[0][b];
    }
  }
}

// Location-sensitive energies, one warp per (b, t_enc):
//   q = rnd(pq[b] + pm[b, t] + [prev | cum] window . wloc)
//   energy[b, t] = mask ? -1e9 : (tanh(q) . v + v_b) * escale
// wloc is the composed (2K, A) location conv + dense matrix.  qsum_out,
// where not null, receives q in W as (B, T, A).  win_all: kWarps * 2K
// floats of shared memory.
template <typename W>
__device__ inline void energy_phase(const W* wloc, const float* prev,
                                    const float* cum, const float* pq,
                                    const float* pm, const float* v,
                                    const uint8_t* mask, float v_b,
                                    float escale, float* energy, W* qsum_out,
                                    float* win_all, int B, int T, int A, int K,
                                    int gw, int nw, int lane, int warp) {
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
    for (int j = lane; j < A; j += 32) {
      float loc = 0.f;
      for (int i = 0; i < 2 * K; ++i)
        loc = fmaf(win[i], to_f(wloc[(size_t)i * A + j]), loc);
      const float q = rnd<W>(__ldcg(pq + (size_t)b * A + j) +
                             pm[((size_t)b * T + tt) * A + j] + loc);
      if (qsum_out) st_w(qsum_out + ((size_t)b * T + tt) * A + j, q);
      e = fmaf(tanhf(q), v[j], e);
    }
    e = warp_sum(e);
    if (lane == 0) {
      e = (e + v_b) * escale;
      energy[(size_t)b * T + tt] = mask[(size_t)b * T + tt] ? -1e9f : e;
    }
    __syncwarp();
  }
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
