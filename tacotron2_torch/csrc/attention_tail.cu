// Attention tail for Hopper (sm_90a): energies -> masked softmax -> context,
// one decoder step.
//
// Replaces the Pallas TPU kernel tacotron2_tpu/ops/attention_kernel.py::
// attention_tail (its forward; the backward is plain jnp there and plain
// PyTorch in the wrapper, ops/attention_kernel.py):
//
//     e    = scale * (tanh(qsum) . v_w + v_b)   fp32 tanh, fp32 energies
//     e    = where(mask, -1e9, e)
//     attn = softmax(e)                         over T_enc
//     ctx  = attn @ memory                      memory rounded to qsum's
//                                               dtype, summed in fp32
//
// What bounds it on an H100: bytes.  A call reads qsum (B, T, A), memory
// (B, T, D) (fp32 as the decoder hands it over: about 0.9 of the bytes)
// and the mask, and writes attn and ctx; at B=4, T=112 that is 1.04 MB,
// 0.31 us at 3.35 TB/s.  At the decode's shapes a call is a chain of
// dependent steps (loads, reductions, an exchange between blocks), so its
// latency, not the memory rate, is what the design works on: one round
// trip to device memory before the energies, none after them but the
// stores, and no cluster-wide barrier in the way of the exchange.
//
// The design.  One thread-block cluster of S blocks (S <= 8, the portable
// size) per batch item, split along T_enc: block r of item b takes rows
// [r * rows, (r + 1) * rows) of [0, T).  The wrapper's plan
// (ops/attention_kernel.py::tail_plan) picks S, rows, and the tile of
// memory rows staged at once.
//   1. At entry one thread starts 1-D bulk copies (the Tensor Memory
//      Accelerator) of the block's first two tiles of memory rows into a
//      two-stage ring in shared memory; they run under the energies.
//      Where a memory row is no multiple of 16 bytes (or the tensor not
//      16-byte aligned) no bulk copy can take it: a second build of the
//      kernel copies each tile with plain loads when it needs it, into
//      rows padded with zeros to 16 bytes.
//   2. Tile by tile (one tile unless the rows do not fit a stage): the
//      energies, one warp a row and two rows in flight a warp, a lane
//      four consecutive values of each (one 8- or 16-byte load; the
//      second build, which also serves an A no multiple of 4 or qsum and
//      v_w not aligned for it, makes four loads, zero past A, which add
//      nothing), v_w, v_b
//      and the scale loaded once at entry, tanh by a rational function
//      with one reciprocal, the dot summed by warp shuffles; the tile's
//      max joins the block's running max m, p = exp(e - m), the
//      running sum s and the fp32 partial context (each thread its own
//      columns, memory read from the ring and rounded to bf16 in
//      registers where qsum is bf16 and memory fp32) are rescaled by
//      exp(m_old - m) and take the tile's terms: the online softmax, so
//      nothing grows with T_enc but the rows' e of all tiles but the last,
//      which wait in attn.
//   3. The exchange: every block writes its (m, s) into every block of the
//      cluster, and column slice q of its partial context, [q, q + 1) *
//      ceil(D / S), into block q, by asynchronous stores into distributed
//      shared memory (st.async) that complete the receiving block's own
//      mbarrier, which expects exactly those bytes: a block waits for what
//      it receives, not on a cluster barrier (whose release compiles to a
//      GPU-wide fence).  Then every warp forms M = max m_r and Z = sum
//      s_r exp(m_r - M) over its lanes in one fixed order (the same bits
//      in every block), the block its slice of ctx = (sum_r exp(m_r - M)
//      partial_r in rank order) / Z, and attn = exp(e - M) / Z for its own
//      rows, both by one reciprocal of Z.  A row whose positions are
//      all padded comes out uniform, as in the reference.  No block reads
//      another's shared memory, and a block leaves only once everything
//      addressed to it has landed, so none waits for the others to leave.
//      The cluster's one barrier phase, arrived at on entry and awaited
//      before the first store, only makes sure every block has started.
// No atomics: two launches give the same bits.  The "// phase: NAME"
// comments mark where tools/attention_tail_probe.py --phases reads the
// clock.
//
// Plain C interface (ctypes): each entry point returns a CUDA error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_IN_FLIGHT = 2;     // energies: rows a warp sums at once
constexpr int COPIER = THREADS - 32;  // starts the copies: the last warp,
                                      // which has the fewest rows
constexpr int MAX_SPLIT = 8;          // portable cluster size
constexpr int MAX_ITEMS = 65535;      // batch items a launch: grid rows
constexpr long long SMEM_LIMIT = 232448;
// shared memory head: the ring's two mbarriers and the exchange's (0),
// each warp's max (32) and sum (64) of the tile, every block's (m, s)
// (128); then the ring
constexpr int HEAD_BYTES = 256;

enum Flags {
  Q_BF16 = 1,
  MEM_BF16 = 2,
  VW_BF16 = 4,
  VB_BF16 = 8,
  SCALE_BF16 = 16,
};

struct TailArgs {
  const void* qsum;            // (B, T, A) fp32 or bf16
  const void* v_w;             // (A,)
  const void* v_b;             // one value
  const void* scale;           // one value
  const unsigned char* mask;   // (B, T) bool, 1 = pad
  const void* memory;          // (B, T, D) fp32 or bf16
  float* attn;                 // (B, T)
  float* ctx;                  // (B, D)
  int T, A, D, rows, tile_rows, flags;
};

__host__ __device__ constexpr long long up16(long long x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory.
struct Layout {
  long long stage, partial, slices, e, p, total;
};

// The ring's row stride in elements: D padded to 16 bytes (D itself where
// a row is a multiple of 16 bytes, as the bulk copy needs).
__host__ __device__ constexpr int row_stride(int D, int mem_bytes) {
  return (int)(up16((long long)D * mem_bytes) / mem_bytes);
}

// Byte offsets of the dynamic shared memory (ops/attention_kernel.py::
// tail_plan computes the same total); ld: the ring's row stride
__host__ __device__ inline Layout layout(int D, int ld, int split, int rows,
                                         int tile_rows, int mem_bytes) {
  Layout l;
  const int stages = rows > tile_rows ? 2 : 1;
  const long long cols = (D + split - 1) / split;
  l.stage = (long long)tile_rows * ld * mem_bytes;
  l.partial = HEAD_BYTES + stages * l.stage;
  l.slices = l.partial + up16(4LL * D);
  l.e = l.slices + up16(4LL * split * cols);
  l.p = l.e + up16(4LL * tile_rows);
  l.total = l.p + up16(4LL * tile_rows);
  return l;
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

// the same wait with cluster-scope acquire: for bytes other blocks store
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival that also sets the bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

// the address of `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// an asynchronous store into another block's shared memory that completes
// 4 bytes of that block's mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void store_remote(uint32_t addr, float v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float scalar_at(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive values, 16-byte (fp32) or 8-byte (bf16) aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// values c0 .. c0 + 3 of a row of n: one vector load (kFast), else four
// loads with zeros past n
template <bool kFast, typename T>
__device__ __forceinline__ float4 load4_at(const T* row, int c0, int n) {
  if constexpr (kFast) {
    return load4(row + c0);
  } else {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = c0 + u < n ? widen(row[c0 + u]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// tanh(x) by the rational approximation Eigen and XLA use (odd degree 13
// over even degree 6, x clamped to |x| <= 7.905): one reciprocal on the
// special-function unit and FMAs, where tanhf or 1 - 2 / (exp(2x) + 1)
// take two or more; absolute error below 4e-7 (3.4e-7 over [-12, 12]
// against a float64 tanh)
__device__ __forceinline__ float fast_tanh(float x) {
  x = fminf(fmaxf(x, -7.90531110763549805f), 7.90531110763549805f);
  const float x2 = x * x;
  float p = fmaf(x2, -2.76076847742355e-16f, 2.00018790482477e-13f);
  p = fmaf(x2, p, -8.60467152213735e-11f);
  p = fmaf(x2, p, 5.12229709037114e-08f);
  p = fmaf(x2, p, 1.48572235717979e-05f);
  p = fmaf(x2, p, 6.37261928875436e-04f);
  p = fmaf(x2, p, 4.89352455891786e-03f);
  float q = fmaf(x2, 1.19825839466702e-06f, 1.18534705686654e-04f);
  q = fmaf(x2, q, 2.26843463243900e-03f);
  q = fmaf(x2, q, 4.89352518554385e-03f);
  return __fdividef(x * p, q);
}

// two consecutive memory values of a row in shared memory, rounded to
// bf16 first where the plain version rounds memory to qsum's bf16
template <bool kRound>
__device__ __forceinline__ float2 pair_at(const float* p) {
  float2 v = *reinterpret_cast<const float2*>(p);
  if (kRound) {
    v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  }
  return v;
}
template <bool kRound>
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// kFast: qsum and v_w by 4-value vector loads and memory by bulk copy (A
// a multiple of 4, memory rows a multiple of 16 bytes, the pointers
// aligned for both); else four loads a lane and memory by plain loads.
// Two builds, so that the fast one carries none of the other's code: the
// registers it takes decide how many blocks an SM holds at B=64.
template <typename TQ, typename TM, bool kFast>
__global__ void __launch_bounds__(THREADS, 1)
    attention_tail_kernel(const TailArgs a) {
  // memory rounded to bf16 in registers, as the plain version's
  // memory.to(qsum.dtype)
  constexpr bool kRound = std::is_same<TQ, __nv_bfloat16>::value &&
                          std::is_same<TM, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // ring rows: D itself where the bulk copy lays rows back to back
  const int ld = kFast ? a.D : row_stride(a.D, (int)sizeof(TM));
  const Layout l = layout(a.D, ld, split, a.rows, a.tile_rows,
                          (int)sizeof(TM));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // ring 0, 1; [2]
  float* warp_m = reinterpret_cast<float*>(smem + 32);
  float* warp_s = reinterpret_cast<float*>(smem + 64);
  float* stats = reinterpret_cast<float*>(smem + 128);   // [MAX_SPLIT][2]
  TM* ring = reinterpret_cast<TM*>(smem + HEAD_BYTES);
  float* partial = reinterpret_cast<float*>(smem + l.partial);
  float* slices = reinterpret_cast<float*>(smem + l.slices);
  float* e_tile = reinterpret_cast<float*>(smem + l.e);
  float* p_tile = reinterpret_cast<float*>(smem + l.p);

  const int r0 = rank * a.rows;
  const int n = max(0, min(a.rows, a.T - r0));   // this block's rows
  const int n_tiles = (n + a.tile_rows - 1) / a.tile_rows;
  const long long stage_elems = (long long)a.tile_rows * ld;
  const TM* mem = static_cast<const TM*>(a.memory) +
                  ((long long)b * a.T + r0) * a.D;
  const auto tile_n = [&](int k) { return min(a.tile_rows,
                                              n - k * a.tile_rows); };
  const auto start_tile = [&](int k) {   // by one thread
    const uint32_t bytes = (uint32_t)(tile_n(k) * a.D * (int)sizeof(TM));
    mbar_arrive_expect(&bars[k & 1], bytes);
    bulk_copy(ring + (k & 1) * stage_elems,
              mem + (long long)k * a.tile_rows * a.D, bytes, &bars[k & 1]);
  };
  // the same tile by every thread of the block, by plain loads, its rows
  // padded with zeros to ld
  const auto copy_tile = [&](int k) {
    TM* dst = ring + (k & 1) * stage_elems;
    const TM* src = mem + (long long)k * a.tile_rows * a.D;
    const int count = tile_n(k) * ld;
    for (int i = tid; i < count; i += THREADS) {
      const int row = i / ld, c = i - row * ld;
      dst[i] = c < a.D ? src[(long long)row * a.D + c] : TM(0.f);
    }
  };

  // the energies' operands that do not change: a lane's first four
  // values of v_w, v_b and the scale, loaded before anything waits
  const int vw_bf16 = a.flags & VW_BF16;
  const auto v_w_at = [&](int c0) {
    return vw_bf16 ? load4_at<kFast>(
                         static_cast<const __nv_bfloat16*>(a.v_w), c0, a.A)
                   : load4_at<kFast>(static_cast<const float*>(a.v_w), c0,
                                     a.A);
  };
  const float4 w_first =
      4 * lane < a.A ? v_w_at(4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float v_b = scalar_at(a.v_b, 0, a.flags & VB_BF16);
  const float scale = scalar_at(a.scale, 0, a.flags & SCALE_BF16);

  // 1. memory's first two tiles start now; the cluster's first barrier
  // phase (every block has started) is awaited before the exchange
  // phase: start
  const int cols = (a.D + split - 1) / split;   // ctx columns a block sums
  if (tid == COPIER) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if constexpr (kFast) {
      for (int k = 0; k < 2 && k < n_tiles; ++k) start_tile(k);
    }
    // the exchange brings every block's (m, s) and its partial's slice
    const int my_cols = max(0, min(cols, a.D - rank * cols));
    mbar_arrive_expect(&bars[2], (uint32_t)(split * (2 + my_cols) * 4));
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (lane == 0) warp_s[warp] = 0.f;
  // phase: copies started

  // 2. tile by tile: energies, online softmax, partial context
  const TQ* q = static_cast<const TQ*>(a.qsum) +
                ((long long)b * a.T + r0) * a.A;
  const unsigned char* pad = a.mask + (long long)b * a.T + r0;
  float* attn = a.attn + (long long)b * a.T + r0;
  float m_run = -INFINITY;
  for (int k = 0; k < n_tiles; ++k) {
    const int nk = tile_n(k);
    const int t0 = k * a.tile_rows;
    const bool last = k == n_tiles - 1;
    float m_w = -INFINITY;
    for (int base = warp; base < nk; base += WARPS * ROWS_IN_FLIGHT) {
      unsigned char padded[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u)
        padded[u] = base + u * WARPS < nk ? pad[t0 + base + u * WARPS] : 0;
      float acc[ROWS_IN_FLIGHT] = {};
      // a lane takes four consecutive columns of each row, 128 a step (all
      // of A = 128 in one): every load of the step before any use
      for (int c0 = 4 * lane; c0 < a.A; c0 += 128) {
        const float4 w = c0 < 128 ? w_first : v_w_at(c0);
        float4 x[ROWS_IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
          const int i = base + u * WARPS;
          x[u] = i < nk ? load4_at<kFast>(q + (long long)(t0 + i) * a.A,
                                          c0, a.A)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
          if (base + u * WARPS < nk) {   // the same for the whole warp
            acc[u] = fmaf(fast_tanh(x[u].x), w.x, acc[u]);
            acc[u] = fmaf(fast_tanh(x[u].y), w.y, acc[u]);
            acc[u] = fmaf(fast_tanh(x[u].z), w.z, acc[u]);
            acc[u] = fmaf(fast_tanh(x[u].w), w.w, acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int i = base + u * WARPS;
        if (i < nk) {   // every lane holds the same v
          const float v = warp_sum(acc[u]);
          const float e = padded[u] ? -1e9f : (v + v_b) * scale;
          if (lane == 0) {
            e_tile[i] = e;
            if (!last) attn[t0 + i] = e;   // read back in step 3
          }
          m_w = fmaxf(m_w, e);
        }
      }
    }
    // phase: energies
    if (lane == 0) warp_m[warp] = m_w;
    __syncthreads();   // the tile's e and every warp's max
    // phase: first barrier
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m_new = fmaxf(m_new, warp_m[w]);
    const float alpha = expf(m_run - m_new);   // 0 on the first tile
    m_run = m_new;
    float s = 0.f;
    for (int i = tid; i < nk; i += THREADS) {
      const float p = expf(e_tile[i] - m_new);
      p_tile[i] = p;
      s += p;
    }
    s = warp_sum(s);
    if (lane == 0) warp_s[warp] = warp_s[warp] * alpha + s;
    // phase: softmax
    if constexpr (kFast) {
      mbar_wait(&bars[k & 1], (k >> 1) & 1);
    } else {
      copy_tile(k);
    }
    // phase: copy landed
    __syncthreads();   // p_tile, and the tile's memory rows have landed
    // phase: second barrier
    const TM* tile = ring + (k & 1) * stage_elems;
    // two columns: c + 1 = D for an odd D reads a zero of the ring's
    // padding and writes partial[D], in the partial's padding to 16 bytes
    for (int c = 2 * tid; c < a.D; c += 2 * THREADS) {
      float acc0 = 0.f, acc1 = 0.f;
      int i = 0;
      for (; i + 4 <= nk; i += 4) {   // four rows' loads, then their sums
        float2 m[4];
        float p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          m[u] = pair_at<kRound>(tile + (long long)(i + u) * ld + c);
          p[u] = p_tile[i + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc0 = fmaf(p[u], m[u].x, acc0);
          acc1 = fmaf(p[u], m[u].y, acc1);
        }
      }
      for (; i < nk; ++i) {
        const float2 m = pair_at<kRound>(tile + (long long)i * ld + c);
        acc0 = fmaf(p_tile[i], m.x, acc0);
        acc1 = fmaf(p_tile[i], m.y, acc1);
      }
      if (k == 0) {   // the first tile writes the partial
        partial[c] = acc0;
        partial[c + 1] = acc1;
      } else {
        partial[c] = partial[c] * alpha + acc0;
        partial[c + 1] = partial[c + 1] * alpha + acc1;
      }
    }
    // phase: context
    if (k + 1 < n_tiles) {
      __syncthreads();   // the stage, e_tile and p_tile are free again
      if constexpr (kFast) {
        if (tid == COPIER && k + 2 < n_tiles) start_tile(k + 2);
      }
    }
  }
  // No plan makes a block without rows (the host refuses one), so this
  // and the max(0, ...) of n guard nothing; the build with them ran 10%
  // faster at B=4 (PERF.md), a matter of the compiler's choices.
  if (n_tiles == 0) __syncthreads();
  float s_blk = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s_blk += warp_s[w];

  // 3. the exchange through distributed shared memory: asynchronous
  // stores that complete the receiving block's mbarrier, no cluster
  // barrier (every block has started: the barrier phase of the entry)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // phase: cluster started
  if (tid < split) {
    const uint32_t bar = cluster_addr(&bars[2], tid);
    const uint32_t to = cluster_addr(stats + 2 * rank, tid);
    store_remote(to, m_run, bar);
    store_remote(to + 4, s_blk, bar);
  }
  for (int c = 2 * tid; c < a.D; c += 2 * THREADS) {   // this thread's own
#pragma unroll
    for (int h = 0; h < 2 && (kFast || c + h < a.D); ++h) {
      const int owner = (c + h) / cols;
      store_remote(
          cluster_addr(slices + rank * cols + c + h - owner * cols, owner),
          partial[c + h], cluster_addr(&bars[2], owner));
    }
  }
  // phase: pushes
  mbar_wait_cluster(&bars[2], 0);
  // phase: exchange landed
  // lane o takes block o's pair; every warp forms the same M, Z and
  // weights exp(m_o - M) in the same order
  const float m_o = lane < split ? stats[2 * lane] : -INFINITY;
  const float s_o = lane < split ? stats[2 * lane + 1] : 0.f;
  float big = m_o;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    big = fmaxf(big, __shfl_xor_sync(~0u, big, o));
  const float w_o = lane < split ? expf(m_o - big) : 0.f;
  const float inv_z = 1.f / warp_sum(s_o * w_o);
  float wt[MAX_SPLIT];
#pragma unroll
  for (int o = 0; o < MAX_SPLIT; ++o) wt[o] = __shfl_sync(~0u, w_o, o);
  float* out = a.ctx + (long long)b * a.D + rank * cols;
  const int my_cols = min(cols, a.D - rank * cols);
  for (int j = tid; j < my_cols; j += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int o = 0; o < MAX_SPLIT; ++o)
      if (o < split) v += wt[o] * slices[o * cols + j];
    out[j] = v * inv_z;
  }
  // phase: ctx written
  const int t_last = (n_tiles - 1) * a.tile_rows;
  for (int i = tid; i < n; i += THREADS) {
    const float e = i >= t_last ? e_tile[i - t_last] : attn[i];
    attn[i] = expf(e - big) * inv_z;
  }
  // phase: attn written
}

template <bool kFast>
const void* kernel_for(int flags) {
  using bf16 = __nv_bfloat16;
  if (flags & Q_BF16) {
    return flags & MEM_BF16
               ? (const void*)attention_tail_kernel<bf16, bf16, kFast>
               : (const void*)attention_tail_kernel<bf16, float, kFast>;
  }
  return flags & MEM_BF16
             ? (const void*)attention_tail_kernel<float, bf16, kFast>
             : (const void*)attention_tail_kernel<float, float, kFast>;
}

constexpr int N_KERNELS = 8;

// Allow a kernel `smem` bytes of dynamic shared memory (once per kernel
// and size: setting the attribute costs a CUDA API call).
cudaError_t allow_smem(const void* kernel, size_t smem) {
  static const void* kernels[N_KERNELS];
  static size_t sizes[N_KERNELS];
  int slot = 0;
  for (; slot < N_KERNELS; ++slot) {
    if (kernels[slot] == kernel) {
      if (sizes[slot] >= smem) return cudaSuccess;
      break;
    }
    if (kernels[slot] == nullptr) break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernels[slot] = kernel;
  sizes[slot] = smem;
  return cudaSuccess;
}

}  // namespace

// Shared memory bytes a block takes for the plan (split, rows, tile_rows).
extern "C" long long t2_attention_tail_smem(int D, int split, int rows,
                                            int tile_rows, int mem_bf16) {
  const int mem_bytes = mem_bf16 ? 2 : 4;
  return layout(D, row_stride(D, mem_bytes), split, rows, tile_rows,
                mem_bytes)
      .total;
}

// qsum (B, T, A), v_w (A,), v_b and scale (one value each), mask (B, T)
// bool, memory (B, T, D), all contiguous; attn (B, T) and ctx (B, D) fp32
// outputs.  flags: Q_BF16 | MEM_BF16 | VW_BF16 | VB_BF16 | SCALE_BF16 (bf16
// where set, else fp32).  split: blocks of an item's cluster (1-8), rows:
// rows a block takes (every block at least one), tile_rows: memory rows a
// ring stage holds.  Any A and D: the build (vector loads and bulk copy,
// or not) is picked here from A, D and the pointers' alignment.  Items
// past the grid's 65535 rows go in further launches of MAX_ITEMS each
// (ops/attention_kernel.py counts them).  Launches on `stream`, does not
// synchronise.  Returns the CUDA error code (0 = ok).
extern "C" int t2_attention_tail(const void* qsum, const void* v_w,
                                 const void* v_b, const void* scale,
                                 const void* mask, const void* memory,
                                 void* attn, void* ctx, int B, int T, int A,
                                 int D, int split, int rows, int tile_rows,
                                 int flags, void* stream) {
  const int mem_bytes = flags & MEM_BF16 ? 2 : 4;
  if (B < 1 || T < 1 || A < 1 || D < 1 || split < 1 || split > MAX_SPLIT ||
      rows < 1 || tile_rows < 1 || tile_rows > rows ||
      (long long)split * rows < T || (long long)(split - 1) * rows >= T) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem =
      layout(D, row_stride(D, mem_bytes), split, rows, tile_rows, mem_bytes)
          .total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int q_bytes = flags & Q_BF16 ? 2 : 4;
  for (int b0 = 0; b0 < B; b0 += MAX_ITEMS) {
    const int n = B - b0 < MAX_ITEMS ? B - b0 : MAX_ITEMS;
    const long long rows0 = (long long)b0 * T;
    const void* q = static_cast<const char*>(qsum) + rows0 * A * q_bytes;
    const void* mem =
        static_cast<const char*>(memory) + rows0 * D * mem_bytes;
    const bool fast = A % 4 == 0 && (D * mem_bytes) % 16 == 0 &&
                      aligned(mem, 16) && aligned(q, 4 * q_bytes) &&
                      aligned(v_w, flags & VW_BF16 ? 8 : 16);
    const void* kernel =
        fast ? kernel_for<true>(flags) : kernel_for<false>(flags);
    cudaError_t err = allow_smem(kernel, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    TailArgs args{q, v_w, v_b, scale,
                  static_cast<const unsigned char*>(mask) + rows0, mem,
                  static_cast<float*>(attn) + rows0,
                  static_cast<float*>(ctx) + (long long)b0 * D,
                  T, A, D, rows, tile_rows, flags};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, n, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* kargs[] = {&args};
    err = cudaLaunchKernelExC(&cfg, kernel, kargs);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
