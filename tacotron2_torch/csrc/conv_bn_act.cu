// Fused eval-mode Conv1d + BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tacotron2_tpu/ops/convbn_kernel.py::
// conv_bn_act_pallas.  With the BatchNorm folded into the weights on the
// host side (ops/convbn_kernel.py::fold_conv_bn) the layer is
//
//     out[b, co, t] = act( sum_{tap, ci} w[tap, co, ci] * x[b, ci, t + tap - pad]
//                          + h[co] )
//
// with x rounded to the weight dtype, the sum kept in fp32, zeros outside
// [0, T) ('same' padding, pad = (K - 1) / 2) and one fp32 write.
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
// into tiles of 64 output channels x 64 time steps of one batch item
// (grid = time tiles x channel tiles x B), and a block walks over C_in in
// chunks: it stages the K weight slices (64 x chunk) and the input slice
// with its halo (chunk x (64 + K - 1), masked reads instead of a padded
// copy, rounded to the weight dtype on the way) in shared memory, and
// accumulates the K shifted products from there.  bf16 weights go through
// the tensor cores (mma.sync m16n8k16, fp32 accumulate; four warps of
// 32 x 32 outputs each); fp32 weights through plain FMA (a warp owns 16
// channels, a lane two time steps), since TF32 would not be the fp32 the
// plain version computes.  The layouts (B, C, T) in and out are the public
// ones: channels are the product's rows, so a warp's stores run along
// time.  No transposed or padded copy of x is made, bias and activation
// are applied in registers.  A block's chunks are a chain of round trips
// to device memory, and at these sizes that chain's latency, not the
// products, is the kernel's time, so staging is cp.async into two
// buffers: the next chunk's loads are in flight while this chunk's
// products run, and all of a chunk's loads are started before any is
// waited for.  Not done yet: TMA, wgmma, a persistent grid.
//
// Plain C interface (ctypes): t2_conv_bn_act returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CO_TILE = 64;
constexpr int T_TILE = 64;
constexpr int THREADS = 128;
constexpr int MMA_CHUNK = 32;             // input channels a stage, bf16
constexpr int MMA_STRIDE = MMA_CHUNK + 8;  // 80-byte rows: no bank conflicts
constexpr int FMA_CHUNK = 16;             // input channels a stage, fp32
constexpr int FMA_STRIDE = FMA_CHUNK + 4;  // 80-byte rows, 16-byte aligned

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2 };

struct ConvArgs {
  const float* x;   // (B, C_in, T) fp32
  const void* w;    // (K, C_out, C_in) folded weights, fp32 or bf16
  const float* h;   // (C_out,) folded bias
  float* out;       // (B, C_out, T) fp32
  int B, C_in, C_out, T, K, act;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_TANH) return tanhf(v);
  return v;
}

__device__ __forceinline__ void store_rounded(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_rounded(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
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

// Start the copy of the K weight slices of one channel tile and one C_in
// chunk: ws[(tap * CO_TILE + co) * STRIDE + ci] = w[tap, co0 + co, ci0 + ci],
// zero where the tile runs past C_out or C_in (those few are stored
// directly).
template <typename W, int CHUNK, int STRIDE>
__device__ __forceinline__ void stage_weights(const W* __restrict__ w, W* ws,
                                              int C_in, int C_out, int K,
                                              int co0, int ci0) {
  constexpr int VEC = 16 / sizeof(W);
  constexpr int VPR = CHUNK / VEC;
  const bool rows_aligned = (C_in % VEC) == 0;
  const int n_vec = K * CO_TILE * VPR;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    const int v = i % VPR;
    const int row = i / VPR;
    const int co = row % CO_TILE;
    const int tap = row / CO_TILE;
    const int gco = co0 + co;
    const int gci = ci0 + v * VEC;
    W* dst = ws + (tap * CO_TILE + co) * STRIDE + v * VEC;
    const W* src = w + ((size_t)tap * C_out + gco) * C_in + gci;
    if (gco < C_out && rows_aligned && gci + VEC <= C_in) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (gco < C_out && gci + e < C_in) {
          dst[e] = src[e];
        } else {
          store_rounded(dst + e, 0.f);
        }
      }
    }
  }
}

// Start the copy of one C_in chunk of the input with its halo, fp32,
// channel-major: xf[ci * stride + r] = x[b, ci0 + ci, t0 - pad + r], zero
// outside the tensor.  A warp takes whole rows, its lanes run along time.
template <int CHUNK>
__device__ __forceinline__ void stage_input(const float* __restrict__ xb,
                                            float* xf, int C_in, int T,
                                            int rows, int stride, int t_first,
                                            int ci0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int ci = warp; ci < CHUNK; ci += THREADS / 32) {
    const int gci = ci0 + ci;
    const float* xrow = xb + (size_t)gci * T;
    for (int r = lane; r < rows; r += 32) {
      const int gt = t_first + r;
      const bool valid = gci < C_in && gt >= 0 && gt < T;
      cp_async4_zfill(xf + ci * stride + r, valid ? xrow + gt : xb, valid);
    }
  }
}

// bf16 weights: tensor cores.  Shared memory: two weight buffers as
// above, two fp32 input buffers xf as above (rows padded to an odd stride,
// so that the rounding pass reads them across channels without bank
// conflicts), and xs[r][ci], the current
// chunk's input rounded to bf16, with r = t - (t0 - pad) over
// T_TILE + K - 1 rows (time-major, so that a B fragment's two consecutive
// input channels are one 32-bit load).
__global__ void __launch_bounds__(THREADS)
conv_bn_act_mma_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = T_TILE + a.K - 1;
  const int ws_elems = a.K * CO_TILE * MMA_STRIDE;
  __nv_bfloat16* ws_buf = reinterpret_cast<__nv_bfloat16*>(smem);
  const int xf_stride = rows + 1;
  const int xf_elems = MMA_CHUNK * xf_stride;
  float* xf_buf = reinterpret_cast<float*>(ws_buf + 2 * ws_elems);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xf_buf + 2 * xf_elems);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  const int t0 = blockIdx.x * T_TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (a.K - 1) / 2;
  const float* xb = a.x + (size_t)b * a.C_in * a.T;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = (warp & 1) * 32;    // channel offset of the warp's tile
  const int wn = (warp >> 1) * 32;   // time offset of the warp's tile

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int n_chunks = (a.C_in + MMA_CHUNK - 1) / MMA_CHUNK;
  stage_weights<__nv_bfloat16, MMA_CHUNK, MMA_STRIDE>(w, ws_buf, a.C_in,
                                                      a.C_out, a.K, co0, 0);
  stage_input<MMA_CHUNK>(xb, xf_buf, a.C_in, a.T, rows, xf_stride, t0 - pad,
                         0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const __nv_bfloat16* ws = ws_buf + (c & 1) * ws_elems;
    const float* xf = xf_buf + (c & 1) * xf_elems;
    if (c + 1 < n_chunks) {     // the next chunk's loads fly under this one
      stage_weights<__nv_bfloat16, MMA_CHUNK, MMA_STRIDE>(
          w, ws_buf + ((c + 1) & 1) * ws_elems, a.C_in, a.C_out, a.K, co0,
          (c + 1) * MMA_CHUNK);
      stage_input<MMA_CHUNK>(xb, xf_buf + ((c + 1) & 1) * xf_elems, a.C_in,
                             a.T, rows, xf_stride, t0 - pad,
                             (c + 1) * MMA_CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    static_assert(MMA_CHUNK == 32, "a lane rounds one input channel");
    for (int r = warp; r < rows; r += THREADS / 32) {
      xs[r * MMA_STRIDE + lane] = __float2bfloat16_rn(xf[lane * xf_stride + r]);
    }
    __syncthreads();

    for (int tap = 0; tap < a.K; ++tap) {
#pragma unroll
      for (int kk = 0; kk < MMA_CHUNK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* p =
              ws + (tap * CO_TILE + wm + mi * 16 + g) * MMA_STRIDE + kk + 2 * tig;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * MMA_STRIDE);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * MMA_STRIDE + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* q =
              xs + (wn + ni * 8 + g + tap) * MMA_STRIDE + kk + 2 * tig;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+f"(acc[mi][ni][0]), "+f"(acc[mi][ni][1]),
                  "+f"(acc[mi][ni][2]), "+f"(acc[mi][ni][3])
                : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]),
                  "r"(af[mi][3]), "r"(b0), "r"(b1));
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2 tig, 2 tig + 1), c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm + mi * 16 + g + half * 8;
      if (co >= a.C_out) continue;
      const float hv = a.h[co];
      float* orow = a.out + ((size_t)b * a.C_out + co) * a.T;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + wn + ni * 8 + 2 * tig + e;
          if (t < a.T) orow[t] = activate(acc[mi][ni][half * 2 + e] + hv, a.act);
        }
      }
    }
  }
}

// fp32 weights: plain FMA.  Shared memory: two weight buffers as above and
// two input buffers xs[ci][r] (channel-major as it was copied: a warp's
// lanes read consecutive time steps).  Warp w
// owns channels 16 w .. 16 w + 15 of the tile, lane l time steps l and
// l + 32.
__global__ void __launch_bounds__(THREADS)
conv_bn_act_fma_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws_elems = a.K * CO_TILE * FMA_STRIDE;
  float* ws_buf = reinterpret_cast<float*>(smem);
  float* xs_buf = ws_buf + 2 * ws_elems;
  const float* w = static_cast<const float*>(a.w);

  const int t0 = blockIdx.x * T_TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (a.K - 1) / 2;
  const int rows = T_TILE + a.K - 1;
  const float* xb = a.x + (size_t)b * a.C_in * a.T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int n_chunks = (a.C_in + FMA_CHUNK - 1) / FMA_CHUNK;
  stage_weights<float, FMA_CHUNK, FMA_STRIDE>(w, ws_buf, a.C_in, a.C_out, a.K,
                                              co0, 0);
  stage_input<FMA_CHUNK>(xb, xs_buf, a.C_in, a.T, rows, rows, t0 - pad, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const float* ws = ws_buf + (c & 1) * ws_elems;
    const float* xs = xs_buf + (c & 1) * FMA_CHUNK * rows;
    if (c + 1 < n_chunks) {     // the next chunk's loads fly under this one
      stage_weights<float, FMA_CHUNK, FMA_STRIDE>(
          w, ws_buf + ((c + 1) & 1) * ws_elems, a.C_in, a.C_out, a.K, co0,
          (c + 1) * FMA_CHUNK);
      stage_input<FMA_CHUNK>(xb, xs_buf + ((c + 1) & 1) * FMA_CHUNK * rows,
                             a.C_in, a.T, rows, rows, t0 - pad,
                             (c + 1) * FMA_CHUNK);
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
          xv[c][0] = xs[(c4 + c) * rows + lane + tap];
          xv[c][1] = xs[(c4 + c) * rows + lane + 32 + tap];
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

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int co = co0 + warp * 16 + i;
    if (co >= a.C_out) continue;
    const float hv = a.h[co];
    float* orow = a.out + ((size_t)b * a.C_out + co) * a.T;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = t0 + lane + 32 * j;
      if (t < a.T) orow[t] = activate(acc[i][j] + hv, a.act);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const ConvArgs& a, size_t smem_bytes,
                   cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.T + T_TILE - 1) / T_TILE, (a.C_out + CO_TILE - 1) / CO_TILE,
                  a.B);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (B, C_in, T) fp32, w (K, C_out, C_in) fp32 or bf16 (is_bf16), h (C_out,)
// fp32 -> out (B, C_out, T) fp32.  act: 0 none, 1 relu, 2 tanh.  Launches on
// `stream`, does not synchronise.  Returns the CUDA error code (0 = ok).
extern "C" int t2_conv_bn_act(const float* x, const void* w, const float* h,
                              float* out, int B, int C_in, int C_out, int T,
                              int K, int act, int is_bf16, void* stream) {
  if (B < 1 || C_in < 1 || C_out < 1 || T < 1 || K < 1 || (K % 2) == 0 ||
      B > 65535 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  ConvArgs a{x, w, h, out, B, C_in, C_out, T, K, act};
  const int rows = T_TILE + K - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const size_t smem =
        (size_t)(2 * K * CO_TILE + rows) * MMA_STRIDE * sizeof(__nv_bfloat16) +
        (size_t)2 * MMA_CHUNK * (rows + 1) * sizeof(float);
    return (int)launch(conv_bn_act_mma_kernel, a, smem, s);
  }
  const size_t smem =
      (size_t)2 * (K * CO_TILE * FMA_STRIDE + FMA_CHUNK * rows) * sizeof(float);
  return (int)launch(conv_bn_act_fma_kernel, a, smem, s);
}
