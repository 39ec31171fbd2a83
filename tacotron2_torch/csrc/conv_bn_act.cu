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
// odd and even K) and one fp32 write.  Up to 33 taps the input is staged
// with a halo of HALO steps on either side of a tile, HALO in {4, 8, 16}
// by K (up to 2 HALO + 1 taps), each halo a build of its own.  Past 33
// taps the bf16 weights of one input chunk alone would take more than half
// of a block's shared memory, so a further build (kLong) runs the taps in
// groups of at most LONG_TAPS: a stage holds one group's weight slices and
// the input window that group reaches (96 steps from a multiple of 4 at
// or below the group's first, 16-byte copies as before), and the fp32
// accumulator runs on across the groups and chunks.  Any K that Conv1d
// takes; the wrapper zero-pads the folded weights to whole groups.
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
// with its halo (fp32 rows 16 bytes a copy, masked at the edges, at the
// input's own strides instead of a padded copy).  The K <= 9 builds (halo
// 4) are the serving path's; a longer kernel stages fewer chunks ahead
// (halo 8: two, halo 16: one), so that its K weight slices still fit.
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
constexpr int MAX_K = 33;     // 2 x the largest halo + 1: one tap group
constexpr int LONG_TAPS = 30;  // taps a group holds past MAX_K: its window
                               // starts up to 3 steps early in 96 staged
// steps staged on either side of a tile, by kernel size (past MAX_K: the
// window of 96 steps a tap group stages)
__host__ __device__ constexpr int halo_for(int K) {
  return K <= 9 ? 4 : K <= 17 ? 8 : 16;
}
// tap groups of a kernel size, and the taps each holds (the last may hold
// fewer real ones; the wrapper pads the weights with zero taps to whole
// groups): one group of K up to MAX_K, else groups of up to LONG_TAPS
__host__ __device__ constexpr int tap_groups(int K) {
  return K <= MAX_K ? 1 : (K + LONG_TAPS - 1) / LONG_TAPS;
}
__host__ __device__ constexpr int group_taps(int K) {
  return (K + tap_groups(K) - 1) / tap_groups(K);
}
// a tap group's staged window: the first step it reaches, t0 + g0 - pad,
// rounded down to a multiple of 4 (t0 is one), and how far it was moved
__host__ __device__ inline int window_skip(int g0, int pad) {
  return ((g0 - pad) % 4 + 4) % 4;
}
// a staged channel row: the tile and its halo; 16-byte rows, and float4
// reads of 8 rows hit 8 bank groups (the stride is 4 mod 8 words)
template <int HALO>
struct Staged {
  static constexpr int COLS = T_TILE + 2 * HALO;
  static constexpr int STRIDE = COLS + 4;
  static constexpr int VECS = COLS / 4;
};
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

// Start the copy of the fp32 weight slices of taps [tap0, tap0 + taps) of
// one channel tile and one C_in chunk: ws[(tap * CO_TILE + co) *
// FMA_STRIDE + ci] = w[tap0 + tap, co0 + co, ci0 + ci] (the folded weights
// are padded to whole tiles and chunks: no masks).  The bf16 kernel's
// weights come by TMA instead.
__device__ __forceinline__ void stage_weights(const ConvArgs& a, float* ws,
                                              int co0, int ci0, int tap0,
                                              int taps) {
  constexpr int VPR = FMA_CHUNK / 4;   // float4 copies a row
  const float* w = static_cast<const float*>(a.w);
  const int n_vec = taps * CO_TILE * VPR;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    const int v = i % VPR;
    const int row = i / VPR;
    const int co = row % CO_TILE;
    const int tap = row / CO_TILE;
    cp_async16(ws + (tap * CO_TILE + co) * FMA_STRIDE + v * 4,
               w + ((size_t)(tap0 + tap) * a.C_out_pad + co0 + co) *
                       a.C_in_pad +
                   ci0 + v * 4);
  }
}

// Stage one C_in chunk of the input with a halo of HALO steps, channel-
// major: xf[ci * XF_STRIDE + r] = x[b, ci0 + ci, t_first + r] for r in
// [0, XF_COLS), zero outside the tensor (t_first: t0 - HALO, or a tap
// group's window).  A (B, C, T) fp32 input whose rows are 16-byte aligned
// (a.vec) is copied 16 bytes at a time: t_first is a multiple of 4, so a
// copy lies wholly inside [0, T) or wholly outside it unless T is no
// multiple of 4, where the last one is split.  Any other
// input goes element by element, consecutive threads along its unit-
// stride axis (time, or channels for a transposed (B, T, C) one): fp32 by
// cp.async, bf16 (the embedding of a bf16 model) by plain loads.
template <typename TIn, int CHUNK, int HALO>
__device__ __forceinline__ void stage_input(const ConvArgs& a, int b,
                                            TIn* xf, int t_first, int ci0) {
  constexpr int XF_COLS = Staged<HALO>::COLS;
  constexpr int XF_STRIDE = Staged<HALO>::STRIDE;
  constexpr int XF_VECS = Staged<HALO>::VECS;
  const TIn* x = static_cast<const TIn*>(a.x);
  const TIn* xb = x + (size_t)b * a.sx_b;
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
constexpr int WG_MAX_K = 7;   // taps held in registers by the build that
                              // serves K <= 7; the others hold 9
constexpr int WG_TAP_GROUP = 9;   // taps whose operands a thread holds at
                                  // once; longer kernels run groups of 9
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

// one thread: the weight slices of a stage's taps (from tap0) of channel
// tile co0 and input chunk ci0 into `dst`, completing `bar`
__device__ __forceinline__ void tma_weights(const CUtensorMap* map,
                                           void* dst, uint64_t* bar,
                                           int bytes, int ci0, int co0,
                                           int tap0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ci0), "r"(co0), "r"(tap0),
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
template <typename TIn, int HALO>
__device__ __forceinline__ void round_input(const TIn* xf, __nv_bfloat16* xs,
                                            int rows, int skip) {
  constexpr int XF_STRIDE = Staged<HALO>::STRIDE;
  constexpr int XF_VECS = Staged<HALO>::VECS;
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

// chunks staged ahead in the ring, by halo: all K weight slices of a chunk
// are one stage, so the longer kernels hold fewer
__host__ __device__ constexpr int wg_stages(int halo) {
  return halo == 4 ? 3 : halo == 8 ? 2 : 1;
}

struct WgLayout {   // byte offsets into the 1024-aligned dynamic shared memory
  int ws, xf, xs, bar, total;
};

template <int HALO>
__host__ __device__ inline WgLayout wg_layout(int K, int x_bytes) {
  constexpr int STAGES = wg_stages(HALO);
  const int rows = T_TILE + K - 1;
  WgLayout l;
  l.ws = 0;
  l.xf = STAGES * K * WG_TAP_BYTES;
  l.xs = l.xf +
         ((STAGES * WG_CHUNK * Staged<HALO>::STRIDE * x_bytes + 15) & ~15);
  l.bar = l.xs + ((rows * WG_XS * 2 + 7) & ~7);
  l.total = l.bar + STAGES * 8;
  if (l.total < RED_BYTES) l.total = RED_BYTES;
  return l;
}

// kLong: K past MAX_K, a stage per (chunk, tap group) of group_taps(K)
// taps, the group's window staged (kMaxK = LONG_TAPS, HALO = 16)
template <typename TIn, int kMaxK, int HALO, bool kLong = false>
__global__ void __launch_bounds__(THREADS)
conv_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         ConvArgs a) {
  constexpr int WG_STAGES = wg_stages(HALO);
  static_assert(kMaxK <= 2 * HALO + 1, "the halo holds kMaxK taps");
  static_assert(!kLong || (kMaxK == LONG_TAPS && HALO == 16),
                "a long kernel's window");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // taps a stage holds, and the stages (tap groups) of a chunk
  const int TG = kLong ? group_taps(a.K) : a.K;
  const int NG = kLong ? tap_groups(a.K) : 1;
  const WgLayout l = wg_layout<HALO>(TG, sizeof(TIn));
  const int rows = T_TILE + TG - 1;
  const int xf_elems = WG_CHUNK * Staged<HALO>::STRIDE;
  TIn* xf_buf = reinterpret_cast<TIn*>(smem + l.xf);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + l.xs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bar);
  const int stage_bytes = TG * WG_TAP_BYTES;

  const Tile tl = tile_of(a, WG_CHUNK);
  const int pad = (a.K - 1) / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i of this block's chunks (chunk i / NG, tap group i % NG):
  // weights by TMA, the input by cp.async; one cp.async group a stage,
  // empty past the last chunk
  auto start_stage = [&](int i) {
    const int c = tl.c_begin + i / NG;
    if (c < tl.c_end) {
      const int s = i % WG_STAGES;
      const int g0 = (i % NG) * TG;
      const int t_first =
          kLong ? tl.t0 + g0 - pad - window_skip(g0, pad) : tl.t0 - HALO;
      if (threadIdx.x == 0) {
        tma_weights(&wmap, smem + l.ws + s * stage_bytes, &bars[s],
                    stage_bytes, c * WG_CHUNK, tl.co0, g0);
      }
      stage_input<TIn, WG_CHUNK, HALO>(a, tl.b, xf_buf + s * xf_elems,
                                       t_first, c * WG_CHUNK);
    }
    cp_async_commit();
  };

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  // kLong: the tensor cores sum each stage (at most 32 x LONG_TAPS
  // products an output) from zero into acc, and the stages are added in
  // fp32 into total, so that no sum runs over a whole long kernel's
  // K x C_in products inside the tensor cores
  float total[kLong ? 32 : 1];
  if constexpr (kLong) {
#pragma unroll
    for (int j = 0; j < 32; ++j) total[j] = 0.f;
  }

  const int n = (tl.c_end - tl.c_begin) * NG;
  for (int i = 0; i < WG_STAGES - 1; ++i) start_stage(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % WG_STAGES;
    const int g0 = (i % NG) * TG;
    // the stage's real taps: all K, or its group's (the last may hold
    // zero taps of the padding, which add nothing and are skipped)
    const int taps = kLong ? min(TG, a.K - g0) : a.K;
    start_stage(i + WG_STAGES - 1);   // into the stage the last chunk freed
    cp_async_wait<WG_STAGES - 1>();
    mbar_wait(&bars[s], (i / WG_STAGES) & 1);
    __syncthreads();
    round_input<TIn, HALO>(xf_buf + s * xf_elems, xs, rows,
                           kLong ? window_skip(g0, pad) : HALO - pad);
    __syncthreads();

    const unsigned char* ws = smem + l.ws + s * stage_bytes;
    // lane l addresses row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16) of
    // the warp's 16 x 16 A block: a0..a3 in mma's fragment order
    const __nv_bfloat16* xrow =
        xs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * WG_XS +
        8 * (lane >> 4);
    // the taps in groups of at most WG_TAP_GROUP (one group up to K = 9):
    // every tap's A fragments of a group first, since a register that a
    // wgmma in flight reads is not written again before the wait
    constexpr int kGroup = kMaxK < WG_TAP_GROUP ? kMaxK : WG_TAP_GROUP;
    constexpr int kGroups = (kMaxK + kGroup - 1) / kGroup;
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
      const int tap0 = grp * kGroup;
      if (grp == 0 || tap0 < taps) {
        uint32_t af[kGroup][2][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (tap0 + j < taps) {
            ldmatrix_x4(af[j][0], xrow + (tap0 + j) * WG_XS);
            ldmatrix_x4(af[j][1], xrow + (tap0 + j) * WG_XS + 16);
          }
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (tap0 + j < taps) {
            const unsigned char* wt = ws + (tap0 + j) * WG_TAP_BYTES;
            wgmma_m64n64k16(acc, af[j][0], desc_sw64(wt));
            wgmma_m64n64k16(acc, af[j][1], desc_sw64(wt + 32));
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
    }
    if constexpr (kLong) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        total[j] += acc[j];
        acc[j] = 0.f;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (kLong) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = total[j];
  }

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

// fp32 weights: plain FMA.  Shared memory: weight buffers as above and
// input buffers xs[ci][r] (channel-major as it was copied: a warp's lanes
// read consecutive time steps), two of each (the next chunk's loads fly
// under this one's products), one of each for halo 16, whose 33 weight
// slices of a chunk take 169 KB.  Warp w owns channels 16 w .. 16 w + 15 of
// the tile, lane l time steps l and l + 32.
__host__ __device__ constexpr int fma_buffers(int halo) {
  return halo == 16 ? 1 : 2;
}

// kLong: K past MAX_K, one stage per (chunk, tap group) of group_taps(K)
// taps and the group's window (HALO = 16, one buffer)
template <int HALO, bool kLong = false>
__global__ void __launch_bounds__(THREADS)
conv_bn_act_fma_kernel(ConvArgs a) {
  constexpr int XF_STRIDE = Staged<HALO>::STRIDE;
  constexpr int BUFS = fma_buffers(HALO);
  static_assert(!kLong || (HALO == 16 && BUFS == 1), "a long kernel's window");
  extern __shared__ __align__(16) unsigned char smem[];
  const int TG = kLong ? group_taps(a.K) : a.K;   // taps a stage holds
  const int NG = kLong ? tap_groups(a.K) : 1;
  const int ws_elems = TG * CO_TILE * FMA_STRIDE;
  float* ws_buf = reinterpret_cast<float*>(smem);
  float* xs_buf = ws_buf + BUFS * ws_elems;

  const Tile tl = tile_of(a, FMA_CHUNK);
  const int pad = (a.K - 1) / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = 0.f;

  if (BUFS == 2 && tl.c_begin < tl.c_end) {
    stage_weights(a, ws_buf, tl.co0, tl.c_begin * FMA_CHUNK, 0, a.K);
    stage_input<float, FMA_CHUNK, HALO>(a, tl.b, xs_buf, tl.t0 - HALO,
                                        tl.c_begin * FMA_CHUNK);
    cp_async_commit();
  }
  for (int i = 0; i < (tl.c_end - tl.c_begin) * NG; ++i) {
    const int c = tl.c_begin + i / NG;
    const int g0 = (i % NG) * TG;
    const int taps = kLong ? min(TG, a.K - g0) : a.K;
    const int buf = BUFS == 2 ? (c - tl.c_begin) & 1 : 0;
    const float* ws = ws_buf + buf * ws_elems;
    const float* xs = xs_buf + buf * FMA_CHUNK * XF_STRIDE +
                      (kLong ? window_skip(g0, pad) : HALO - pad);
    if (BUFS == 1) {            // this stage's loads, then its products
      stage_weights(a, ws_buf, tl.co0, c * FMA_CHUNK, g0, taps);
      stage_input<float, FMA_CHUNK, HALO>(
          a, tl.b, xs_buf,
          kLong ? tl.t0 + g0 - pad - window_skip(g0, pad) : tl.t0 - HALO,
          c * FMA_CHUNK);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (c + 1 < tl.c_end) {  // the next chunk's loads fly under this
      stage_weights(a, ws_buf + (buf ^ 1) * ws_elems, tl.co0,
                    (c + 1) * FMA_CHUNK, 0, a.K);
      stage_input<float, FMA_CHUNK, HALO>(
          a, tl.b, xs_buf + (buf ^ 1) * FMA_CHUNK * XF_STRIDE, tl.t0 - HALO,
          (c + 1) * FMA_CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int tap = 0; tap < taps; ++tap) {
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

template <int HALO>
size_t smem_bytes_for(int is_bf16, int x_bf16, int K) {
  if (is_bf16) return (size_t)wg_layout<HALO>(K, x_bf16 ? 2 : 4).total + 1024;
  const size_t n = fma_buffers(HALO) *
                   (K * CO_TILE * FMA_STRIDE + FMA_CHUNK * Staged<HALO>::STRIDE) *
                   sizeof(float);
  return n > (size_t)RED_BYTES ? n : (size_t)RED_BYTES;
}

// past MAX_K a stage holds one tap group
size_t smem_bytes(int is_bf16, int x_bf16, int K) {
  if (K > MAX_K) return smem_bytes_for<16>(is_bf16, x_bf16, group_taps(K));
  switch (halo_for(K)) {
    case 4: return smem_bytes_for<4>(is_bf16, x_bf16, K);
    case 8: return smem_bytes_for<8>(is_bf16, x_bf16, K);
    default: return smem_bytes_for<16>(is_bf16, x_bf16, K);
  }
}

template <int kMaxK, int HALO, bool kLong = false>
const void* wgmma_kernel_for(int x_bf16) {
  return x_bf16 ? (const void*)
                      conv_bn_act_wgmma_kernel<__nv_bfloat16, kMaxK, HALO,
                                               kLong>
                : (const void*)
                      conv_bn_act_wgmma_kernel<float, kMaxK, HALO, kLong>;
}

// the build for these weights and K: halo 4 up to 9 taps (two bf16 builds,
// up to 7 and 9 taps in registers), 8 up to 17, 16 up to 33, then tap
// groups of up to LONG_TAPS
const void* kernel_for(int is_bf16, int x_bf16, int K) {
  const int halo = halo_for(K);
  if (!is_bf16) {
    return K > MAX_K   ? (const void*)conv_bn_act_fma_kernel<16, true>
           : halo == 4 ? (const void*)conv_bn_act_fma_kernel<4>
           : halo == 8 ? (const void*)conv_bn_act_fma_kernel<8>
                       : (const void*)conv_bn_act_fma_kernel<16>;
  }
  if (K <= WG_MAX_K) return wgmma_kernel_for<WG_MAX_K, 4>(x_bf16);
  if (halo == 4) return wgmma_kernel_for<9, 4>(x_bf16);
  if (halo == 8) return wgmma_kernel_for<17, 8>(x_bf16);
  if (K <= MAX_K) return wgmma_kernel_for<MAX_K, 16>(x_bf16);
  return wgmma_kernel_for<LONG_TAPS, 16, true>(x_bf16);
}

// Allow the kernel `smem` bytes of dynamic shared memory (once per kernel
// and size: setting the attribute costs a CUDA API call).
cudaError_t allow_smem(const void* kernel, size_t smem) {
  constexpr int N = 16;   // 14 builds
  static const void* kernels[N];
  static size_t sizes[N];
  for (int i = 0; i < N; ++i) {
    if (kernels[i] == kernel && sizes[i] >= smem) return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < N; ++i) {
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
// with bf16 weights (x_bf16); w (K', C_out_pad, C_in_pad) fp32 or bf16
// (is_bf16), K' = tap_groups(K) * group_taps(K) (K itself up to MAX_K,
// zero taps past K), C_out_pad a multiple of 64, C_in_pad of 32, with `wmap` its
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
  if (B < 1 || C_in < 1 || C_out < 1 || T < 1 || K < 1 ||
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
// boxes of 32 input channels x 64 output channels x K taps (past MAX_K, K
// whole tap groups: a group's taps, K / tap_groups(K)), 64-byte swizzle,
// written into `map` (128 bytes).  cuTensorMapEncodeTiled is
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
  const cuuint32_t box[3] = {WG_CHUNK, CO_TILE,
                             (cuuint32_t)(K / tap_groups(K))};
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
