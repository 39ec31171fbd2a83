// Fused eval-mode Conv1d + BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tacotron2_tpu/ops/convbn_kernel.py::
// conv_bn_act_pallas.  With the BatchNorm folded into the weights on the
// host side (ops/convbn_kernel.py::folded_weights, once per layer) the
// layer is
//
//     out[b, co, t] = act( sum_{tap, ci} w[tap, co, ci] * x[b, ci, t + tap - pad]
//                          + h[co] )
//
// with x rounded to the weight dtype, the sum kept in fp32, zeros outside
// [0, T) ('same' padding, pad = (K - 1) / 2 before and K / 2 after, for
// odd and even K) and one fp32 write.  K up to 2 HALO + 1 = 9 taps: the
// input is staged with HALO steps on either side of a tile.
//
// What bounds it on an H100: at the serving shapes (K = 5, 512 channels)
// a layer is 2*B*T*C_in*C_out*K operations over about B*T*(C_in + C_out)*4
// + K*C_in*C_out*2 bytes, i.e. roughly 400*B*T / (B*T + 640) operations a
// byte in bf16: operations (the tensor cores) for B*T above a few
// thousand, bytes (the weights, read once) for a single short request.
//
// What the design does about it.  The TPU program keeps one batch item's
// whole padded row and all K weight matrices in VMEM on a grid of B; that
// is 2.6 MB and no block of this card holds it.  Here the output is cut
// into tiles of 64 output channels x 64 time steps of one batch item, and
// C_in into chunks of 32 (16 for fp32) that are staged in shared memory:
// the K weight slices (64 x chunk, from the folded weights, which the
// wrapper keeps zero-padded to whole tiles and chunks) and the input slice
// with a halo of 4 steps (fp32 rows 16 bytes a copy, masked at the edges,
// at the input's own strides instead of a padded copy).
//
// At the serving shapes the grid of tiles is small (8 tiles for one
// sentence's encoder layer, on 132 SMs) and a block's chunks are a chain
// of round trips to memory, so a tile's C_in is split across a thread-block
// cluster of S blocks (S in 1, 2, 4, 8, the largest whose clusters all fit
// on the card at once, chosen by the wrapper): each block walks its share
// of the chunks, leaves its fp32 partial tile in its shared memory, and
// after a cluster barrier block r sums slice r of the tile (64 / S
// channels) over the S partials through distributed shared memory, in
// rank order, then adds the bias, applies the activation and stores along
// time.  No atomics: two launches give the same bits.
//
// bf16 weights go through the tensor cores by wgmma, the weights staged by
// TMA into a 3-stage ring (below); a body of mma.sync on the same staging
// and split was slower or equal at every shape the smoke times, and is
// gone.  fp32 weights go through plain FMA (a warp owns 16 channels, a
// lane two time steps; two cp.async buffers), since TF32 would not be the
// fp32 the plain version computes.
//
// Plain C interface (ctypes): each entry point returns a CUDA error code.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CO_TILE = 64;
constexpr int T_TILE = 64;
constexpr int THREADS = 128;
constexpr int MAX_SPLIT = 8;               // portable cluster size
constexpr int FMA_CHUNK = 16;              // input channels a stage, fp32
constexpr int FMA_STRIDE = FMA_CHUNK + 4;  // 80-byte rows, 16-byte aligned
constexpr int HALO = 4;                    // steps staged on either side
constexpr int MAX_K = 2 * HALO + 1;
constexpr int XF_COLS = T_TILE + 2 * HALO;  // a staged channel row
constexpr int XF_STRIDE = XF_COLS + 4;      // 16-byte rows; float4 reads of
                                            // 8 rows hit 8 bank groups
constexpr int XF_VECS = XF_COLS / 4;
constexpr int RED_STRIDE = T_TILE + 4;     // the partial tile, [co][t] fp32
constexpr int RED_BYTES = CO_TILE * RED_STRIDE * 4;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2 };

struct ConvArgs {
  const void* x;    // (B, C_in, T) fp32 or bf16, at strides sx_*
  const void* w;    // (K, C_out_pad, C_in_pad) folded, zero padded
  const float* h;   // (C_out,) folded bias
  float* out;       // (B, C_out, T) fp32, contiguous
  long long sx_b, sx_c, sx_t;   // input strides, elements
  int B, C_in, C_out, T, K, C_out_pad, C_in_pad, act, split;
  int vec;   // fp32 rows along time, 16-byte aligned: staged 16 B a copy
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_TANH) return tanhf(v);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// 16 bytes, or zeros where `valid` is false (src must still be an address
// of the tensor)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes, or zeros where `valid` is false (src must still be an address
// of the tensor)
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The output tile of this block and the chunks of C_in its rank walks:
// [c_begin, c_end) of ceil(C_in / chunk), an empty range where there are
// fewer chunks than blocks in the cluster.
struct Tile {
  int rank, t0, co0, b, c_begin, c_end;
};

__device__ __forceinline__ Tile tile_of(const ConvArgs& a, int chunk) {
  const int tiles_t = (a.T + T_TILE - 1) / T_TILE;
  const int n_chunks = (a.C_in + chunk - 1) / chunk;
  Tile tl;
  tl.rank = blockIdx.x;
  tl.t0 = (blockIdx.y % tiles_t) * T_TILE;
  tl.co0 = (blockIdx.y / tiles_t) * CO_TILE;
  tl.b = blockIdx.z;
  tl.c_begin = tl.rank * n_chunks / a.split;
  tl.c_end = (tl.rank + 1) * n_chunks / a.split;
  return tl;
}

// Start the copy of the fp32 K weight slices of one channel tile and one
// C_in chunk: ws[(tap * CO_TILE + co) * FMA_STRIDE + ci] = w[tap, co0 + co,
// ci0 + ci] (the folded weights are padded to whole tiles and chunks: no
// masks).  The bf16 kernel's weights come by TMA instead.
__device__ __forceinline__ void stage_weights(const ConvArgs& a, float* ws,
                                              int co0, int ci0) {
  constexpr int VPR = FMA_CHUNK / 4;   // float4 copies a row
  const float* w = static_cast<const float*>(a.w);
  const int n_vec = a.K * CO_TILE * VPR;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    const int v = i % VPR;
    const int row = i / VPR;
    const int co = row % CO_TILE;
    const int tap = row / CO_TILE;
    cp_async16(ws + (tap * CO_TILE + co) * FMA_STRIDE + v * 4,
               w + ((size_t)tap * a.C_out_pad + co0 + co) * a.C_in_pad + ci0 +
                   v * 4);
  }
}

// Stage one C_in chunk of the input with a halo of HALO steps, channel-
// major: xf[ci * XF_STRIDE + r] = x[b, ci0 + ci, t0 - HALO + r] for r in
// [0, XF_COLS), zero outside the tensor.  A (B, C, T) fp32 input whose rows
// are 16-byte aligned (a.vec) is copied 16 bytes at a time: t0 - HALO is a
// multiple of 4, so a copy lies wholly inside [0, T) or wholly outside it
// unless T is no multiple of 4, where the last one is split.  Any other
// input goes element by element, consecutive threads along its unit-
// stride axis (time, or channels for a transposed (B, T, C) one): fp32 by
// cp.async, bf16 (the embedding of a bf16 model) by plain loads.
template <typename TIn, int CHUNK>
__device__ __forceinline__ void stage_input(const ConvArgs& a, int b,
                                            TIn* xf, int t0, int ci0) {
  const TIn* x = static_cast<const TIn*>(a.x);
  const TIn* xb = x + (size_t)b * a.sx_b;
  const int t_first = t0 - HALO;
  if constexpr (sizeof(TIn) == 4) {
    if (a.vec) {
      for (int i = threadIdx.x; i < CHUNK * XF_VECS; i += THREADS) {
        const int ci = i / XF_VECS;
        const int gt = t_first + 4 * (i % XF_VECS);
        const int gci = ci0 + ci;
        TIn* dst = xf + ci * XF_STRIDE + gt - t_first;
        const TIn* src = xb + (size_t)gci * a.sx_c + gt;
        if (gci >= a.C_in || gt + 4 <= 0 || gt >= a.T || gt + 4 <= a.T) {
          const bool valid = gci < a.C_in && gt >= 0 && gt + 4 <= a.T;
          cp_async16_zfill(dst, valid ? src : x, valid);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cp_async4_zfill(dst + e, gt + e < a.T ? src + e : x,
                            gt + e < a.T);
          }
        }
      }
      return;
    }
  }
  const bool along_t = a.sx_t == 1;
  for (int i = threadIdx.x; i < CHUNK * XF_COLS; i += THREADS) {
    const int ci = along_t ? i / XF_COLS : i % CHUNK;
    const int r = along_t ? i % XF_COLS : i / CHUNK;
    const int gci = ci0 + ci;
    const int gt = t_first + r;
    const bool valid = gci < a.C_in && gt >= 0 && gt < a.T;
    const TIn* src = valid ? xb + gci * a.sx_c + gt * a.sx_t : x;
    if constexpr (sizeof(TIn) == 4) {
      cp_async4_zfill(xf + ci * XF_STRIDE + r, src, valid);
    } else {
      xf[ci * XF_STRIDE + r] = valid ? *src : TIn(0.f);
    }
  }
}

// The block's fp32 partial tile is in `red` ([co][t], RED_STRIDE).  Block
// `rank` of the cluster sums rows [rank, rank + 1) * 64 / S of it over the
// cluster's S partials, in rank order, adds the bias, applies the
// activation and stores along time.
__device__ __forceinline__ void reduce_store(const ConvArgs& a, float* red,
                                             const Tile& tl) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partial is in its shared memory
  const int rows = CO_TILE / a.split;
  const int t = threadIdx.x % T_TILE;
  for (int i = threadIdx.x / T_TILE; i < rows; i += THREADS / T_TILE) {
    const int co_l = tl.rank * rows + i;
    float v = 0.f;
    for (int q = 0; q < a.split; ++q) {
      v += cluster.map_shared_rank(red, q)[co_l * RED_STRIDE + t];
    }
    const int co = tl.co0 + co_l;
    if (co < a.C_out && tl.t0 + t < a.T) {
      a.out[((size_t)tl.b * a.C_out + co) * a.T + tl.t0 + t] =
          activate(v + a.h[co], a.act);
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// bf16 weights: tensor cores through wgmma, the weights staged by TMA.
//
// The weights are the same for every call of a model, so the wrapper makes
// their tensor map once with the fold; one thread starts a stage's copy,
// all K taps of a 64-channel x 32-input-channel slice in one box, into a
// ring of WG_STAGES stages, each with an mbarrier that the copy completes.
// The input chunk of the same stage is copied by cp.async (fp32, at the
// input's strides, masked) and rounded to bf16 in one pass into xs, the
// product's operand layout.
//
// The products.  Every tap reads the input shifted by one time step, and a
// shared-memory operand of wgmma cannot start at an odd row of a swizzle
// atom, so time is on the rows (as in the TPU kernel, x[tap:tap+T] @
// W[tap]): A is the input, xs[t][ci] with 80-byte rows, loaded into
// registers by ldmatrix at the tap's row offset (which needs 16-byte rows
// only); B is the weight tile [co][ci] straight from the TMA's 64-byte
// swizzle.  One warpgroup's m64n64k16 covers the 64 x 64 tile, two of them
// a tap.  The accumulator holds (t, co); the epilogue goes through shared
// memory anyway (the cluster's reduction), where it is written [co][t] so
// that the stores still run along time.  The other way out, channels on
// the rows with the input as B, would need K copies of the input tile, one
// per shift, each written by the rounding pass: K times its stores and
// shared memory, against ldmatrix reads that cost nothing extra here.
constexpr int WG_CHUNK = 32;                 // input channels a stage
constexpr int WG_STAGES = 3;
constexpr int WG_MAX_K = 7;   // taps held in registers by the build that
                              // serves K <= 7; a second build holds MAX_K
constexpr int WG_XS = WG_CHUNK + 8;          // 80-byte rows: ldmatrix 16 B
constexpr int WG_TAP_BYTES = CO_TILE * WG_CHUNK * 2;   // 4 KB, 64 B rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
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

// one thread: the K weight slices of channel tile co0 and input chunk ci0
// into `dst`, completing `bar`
__device__ __forceinline__ void tma_weights(const CUtensorMap* map,
                                           void* dst, uint64_t* bar,
                                           int bytes, int ci0, int co0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ci0), "r"(co0), "r"(0),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major [64 rows][32 bf16] tile in the 64-byte
// swizzle: rows of 64 B, 8-row groups 512 B apart
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The rounding pass: xs[r][ci] = bf16(xf[ci][r + skip]) for r in [0, rows),
// the operand's time-major layout.  fp32 is read 4 steps at a time (a
// thread takes one channel's float4, a warp 32 channels).
template <typename TIn>
__device__ __forceinline__ void round_input(const TIn* xf, __nv_bfloat16* xs,
                                            int rows, int skip) {
  static_assert(WG_CHUNK == 32, "a warp spans the chunk's channels");
  const int ci = threadIdx.x & 31;
  if constexpr (sizeof(TIn) == 4) {
    for (int v = threadIdx.x >> 5; v < XF_VECS; v += THREADS / 32) {
      const float4 q =
          *reinterpret_cast<const float4*>(xf + ci * XF_STRIDE + 4 * v);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * v + j - skip;
        if (r >= 0 && r < rows) xs[r * WG_XS + ci] = __float2bfloat16_rn(e[j]);
      }
    }
  } else {
    for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32) {
      xs[r * WG_XS + ci] = xf[ci * XF_STRIDE + r + skip];
    }
  }
}

struct WgLayout {   // byte offsets into the 1024-aligned dynamic shared memory
  int ws, xf, xs, bar, total;
};

__host__ __device__ inline WgLayout wg_layout(int K, int x_bytes) {
  const int rows = T_TILE + K - 1;
  WgLayout l;
  l.ws = 0;
  l.xf = WG_STAGES * K * WG_TAP_BYTES;
  l.xs = l.xf + ((WG_STAGES * WG_CHUNK * XF_STRIDE * x_bytes + 15) & ~15);
  l.bar = l.xs + ((rows * WG_XS * 2 + 7) & ~7);
  l.total = l.bar + WG_STAGES * 8;
  if (l.total < RED_BYTES) l.total = RED_BYTES;
  return l;
}

template <typename TIn, int kMaxK>
__global__ void __launch_bounds__(THREADS)
conv_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         ConvArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const WgLayout l = wg_layout(a.K, sizeof(TIn));
  const int rows = T_TILE + a.K - 1;
  const int xf_elems = WG_CHUNK * XF_STRIDE;
  TIn* xf_buf = reinterpret_cast<TIn*>(smem + l.xf);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + l.xs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bar);
  const int stage_bytes = a.K * WG_TAP_BYTES;

  const Tile tl = tile_of(a, WG_CHUNK);
  const int pad = (a.K - 1) / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i of this block's chunks: weights by TMA, the input by cp.async;
  // one cp.async group a stage, empty past the last chunk
  auto start_stage = [&](int i) {
    const int c = tl.c_begin + i;
    if (c < tl.c_end) {
      const int s = i % WG_STAGES;
      if (threadIdx.x == 0) {
        tma_weights(&wmap, smem + l.ws + s * stage_bytes, &bars[s],
                    stage_bytes, c * WG_CHUNK, tl.co0);
      }
      stage_input<TIn, WG_CHUNK>(a, tl.b, xf_buf + s * xf_elems, tl.t0,
                                 c * WG_CHUNK);
    }
    cp_async_commit();
  };

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  const int n = tl.c_end - tl.c_begin;
  for (int i = 0; i < WG_STAGES - 1; ++i) start_stage(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % WG_STAGES;
    start_stage(i + WG_STAGES - 1);   // into the stage the last chunk freed
    cp_async_wait<WG_STAGES - 1>();
    mbar_wait(&bars[s], (i / WG_STAGES) & 1);
    __syncthreads();
    round_input<TIn>(xf_buf + s * xf_elems, xs, rows, HALO - pad);
    __syncthreads();

    const unsigned char* ws = smem + l.ws + s * stage_bytes;
    // lane l addresses row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16) of
    // the warp's 16 x 16 A block: a0..a3 in mma's fragment order
    const __nv_bfloat16* xrow =
        xs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * WG_XS +
        8 * (lane >> 4);
    // every tap's A fragments first: a register that a wgmma in flight reads
    // is not written again before the wait
    uint32_t af[kMaxK][2][4];
#pragma unroll
    for (int tap = 0; tap < kMaxK; ++tap) {
      if (tap < a.K) {
        ldmatrix_x4(af[tap][0], xrow + tap * WG_XS);
        ldmatrix_x4(af[tap][1], xrow + tap * WG_XS + 16);
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < kMaxK; ++tap) {
      if (tap < a.K) {
        wgmma_m64n64k16(acc, af[tap][0], desc_sw64(ws + tap * WG_TAP_BYTES));
        wgmma_m64n64k16(acc, af[tap][1],
                        desc_sw64(ws + tap * WG_TAP_BYTES + 32));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  }
  cp_async_wait<0>();

  // the partial tile: acc[j] at time row 16 warp + g + 8 ((j / 2) % 2),
  // channel column 8 (j / 4) + 2 tig + j % 2; written [co][t]
  const int g = lane >> 2;
  const int tig = lane & 3;
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    red[(8 * (j >> 2) + 2 * tig + (j & 1)) * RED_STRIDE + warp * 16 + g +
        8 * ((j >> 1) & 1)] = acc[j];
  }
  reduce_store(a, red, tl);
}

// fp32 weights: plain FMA.  Shared memory: two weight buffers as above and
// two input buffers xs[ci][r] (channel-major as it was copied: a warp's
// lanes read consecutive time steps).  Warp w owns channels 16 w .. 16 w +
// 15 of the tile, lane l time steps l and l + 32.
__global__ void __launch_bounds__(THREADS)
conv_bn_act_fma_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws_elems = a.K * CO_TILE * FMA_STRIDE;
  float* ws_buf = reinterpret_cast<float*>(smem);
  float* xs_buf = ws_buf + 2 * ws_elems;

  const Tile tl = tile_of(a, FMA_CHUNK);
  const int pad = (a.K - 1) / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = 0.f;

  if (tl.c_begin < tl.c_end) {
    stage_weights(a, ws_buf, tl.co0, tl.c_begin * FMA_CHUNK);
    stage_input<float, FMA_CHUNK>(a, tl.b, xs_buf, tl.t0,
                                  tl.c_begin * FMA_CHUNK);
    cp_async_commit();
  }
  for (int c = tl.c_begin; c < tl.c_end; ++c) {
    const int buf = (c - tl.c_begin) & 1;
    const float* ws = ws_buf + buf * ws_elems;
    const float* xs = xs_buf + buf * FMA_CHUNK * XF_STRIDE + HALO - pad;
    if (c + 1 < tl.c_end) {     // the next chunk's loads fly under this one
      stage_weights(a, ws_buf + (buf ^ 1) * ws_elems, tl.co0,
                    (c + 1) * FMA_CHUNK);
      stage_input<float, FMA_CHUNK>(a, tl.b,
                                    xs_buf + (buf ^ 1) * FMA_CHUNK * XF_STRIDE,
                                    tl.t0, (c + 1) * FMA_CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int tap = 0; tap < a.K; ++tap) {
      const float* wt = ws + (tap * CO_TILE + warp * 16) * FMA_STRIDE;
#pragma unroll
      for (int c4 = 0; c4 < FMA_CHUNK; c4 += 4) {
        float xv[4][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          xv[c][0] = xs[(c4 + c) * XF_STRIDE + lane + tap];
          xv[c][1] = xs[(c4 + c) * XF_STRIDE + lane + 32 + tap];
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wt + i * FMA_STRIDE + c4);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j] = fmaf(wv.x, xv[0][j], acc[i][j]);
            acc[i][j] = fmaf(wv.y, xv[1][j], acc[i][j]);
            acc[i][j] = fmaf(wv.z, xv[2][j], acc[i][j]);
            acc[i][j] = fmaf(wv.w, xv[3][j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      red[(warp * 16 + i) * RED_STRIDE + lane + 32 * j] = acc[i][j];
  reduce_store(a, red, tl);
}

size_t smem_bytes(int is_bf16, int x_bf16, int K) {
  if (is_bf16) return (size_t)wg_layout(K, x_bf16 ? 2 : 4).total + 1024;
  const size_t n =
      2 * (K * CO_TILE * FMA_STRIDE + FMA_CHUNK * XF_STRIDE) * sizeof(float);
  return n > (size_t)RED_BYTES ? n : (size_t)RED_BYTES;
}

template <int kMaxK>
const void* wgmma_kernel_for(int x_bf16) {
  return x_bf16 ? (const void*)conv_bn_act_wgmma_kernel<__nv_bfloat16, kMaxK>
                : (const void*)conv_bn_act_wgmma_kernel<float, kMaxK>;
}

const void* kernel_for(int is_bf16, int x_bf16, int K) {
  if (!is_bf16) return (const void*)conv_bn_act_fma_kernel;
  return K <= WG_MAX_K ? wgmma_kernel_for<WG_MAX_K>(x_bf16)
                       : wgmma_kernel_for<MAX_K>(x_bf16);
}

// Allow the kernel `smem` bytes of dynamic shared memory (once per kernel
// and size: setting the attribute costs a CUDA API call).
cudaError_t allow_smem(const void* kernel, size_t smem) {
  static const void* kernels[8];
  static size_t sizes[8];
  for (int i = 0; i < 8; ++i) {
    if (kernels[i] == kernel && sizes[i] >= smem) return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < 8; ++i) {
    if (kernels[i] == kernel || kernels[i] == nullptr) {
      kernels[i] = kernel;
      sizes[i] = smem;
      break;
    }
  }
  return cudaSuccess;
}

}  // namespace

// x (B, C_in, T) at strides (sx_b, sx_c, sx_t) elements, fp32, or bf16
// with bf16 weights (x_bf16); w (K, C_out_pad, C_in_pad) fp32 or bf16
// (is_bf16), C_out_pad a multiple of 64, C_in_pad of 32, with `wmap` its
// tensor map from t2_conv_bn_act_weight_map where bf16; h (C_out,) fp32 ->
// out (B, C_out, T) fp32.  act: 0 none, 1 relu, 2 tanh.  split: blocks of a
// cluster that share a tile's C_in (1, 2, 4 or 8).  Launches on `stream`,
// does not synchronise.  Returns the CUDA error code (0 = ok).
extern "C" int t2_conv_bn_act(const void* x, long long sx_b, long long sx_c,
                              long long sx_t, int x_bf16, const void* w,
                              const void* wmap, const float* h, float* out,
                              int B, int C_in, int C_out, int T, int K,
                              int C_out_pad, int C_in_pad, int act,
                              int is_bf16, int split, void* stream) {
  const int tiles = ((T + T_TILE - 1) / T_TILE) * (C_out_pad / CO_TILE);
  if (B < 1 || C_in < 1 || C_out < 1 || T < 1 || K < 1 || K > MAX_K ||
      B > 65535 || tiles > 65535 || act < 0 || act > 2 ||
      C_out_pad < C_out || C_out_pad % CO_TILE != 0 || C_in_pad < C_in ||
      C_in_pad % WG_CHUNK != 0 || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) != 0 || (x_bf16 && !is_bf16) ||
      (is_bf16 && wmap == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = !x_bf16 && sx_t == 1 && sx_c % 4 == 0 &&
                  (B == 1 || sx_b % 4 == 0) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  ConvArgs a{x, w, h, out, sx_b, sx_c, sx_t, B, C_in, C_out, T, K,
             C_out_pad, C_in_pad, act, split, vec};
  const void* kernel = kernel_for(is_bf16, x_bf16, K);
  const size_t smem = smem_bytes(is_bf16, x_bf16, K);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUtensorMap map;
  void* args_fma[] = {&a};
  void* args_wg[] = {&map, &a};
  if (is_bf16) memcpy(&map, wmap, sizeof(map));
  err = cudaLaunchKernelExC(&cfg, kernel, is_bf16 ? args_wg : args_fma);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The TMA tensor map of bf16 folded weights w (K, C_out_pad, C_in_pad):
// boxes of 32 input channels x 64 output channels x K taps, 64-byte
// swizzle, written into `map` (128 bytes).  cuTensorMapEncodeTiled is
// found through the runtime, so the library links no libcuda.  Returns 0,
// a CUDA error code, or 1000 + the CUresult of the encoder.
extern "C" int t2_conv_bn_act_weight_map(const void* w, int K, int C_out_pad,
                                         int C_in_pad, void* map) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return (int)cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)C_in_pad, (cuuint64_t)C_out_pad,
                              (cuuint64_t)K};
  const cuuint64_t strides[2] = {(cuuint64_t)C_in_pad * 2,
                                 (cuuint64_t)C_out_pad * C_in_pad * 2};
  const cuuint32_t box[3] = {WG_CHUNK, CO_TILE, (cuuint32_t)K};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap made;   // 64-byte aligned, as the encoder wants it
  const CUresult r = encode(
      &made, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(w), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  memcpy(map, &made, sizeof(made));
  return 0;
}

// Clusters of `split` blocks of the kernel for these weights that the card
// holds at once (the wrapper's split rule fills one wave with it), or
// minus a CUDA error code.
extern "C" int t2_conv_bn_act_clusters(int is_bf16, int x_bf16, int K,
                                       int split) {
  const void* kernel = kernel_for(is_bf16, x_bf16, K);
  const size_t smem = smem_bytes(is_bf16, x_bf16, K);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}
