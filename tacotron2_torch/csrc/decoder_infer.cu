// Persistent whole-decode kernel: the eval-mode autoregressive Tacotron 2
// decode (prenet, attention LSTM, location-sensitive attention, decoder
// LSTM, fused projection + gate head, gate stop) as ONE cooperative launch
// whose time loop runs inside the kernel.
//
// Replaces the Pallas kernel tacotron2_tpu/ops/decoder_megakernel.py::
// decoder_infer_mega (whose grid is the time axis, with all weights
// resident in TPU VMEM).  Here every block of a cooperative grid walks the
// same time loop; dependent phases are separated by grid.sync():
//   1 prenet layer 1            4a query projection pq = W_q h_att
//   2 prenet layer 2            4b location features, tanh energies
//   3 attention-LSTM gates+cell 4c softmax, context, prev/cum update
//   5 decoder-LSTM gates+cell   6  proj+gate head, stop bookkeeping
// Matrix-vector work is split over warps by OUTPUT: an LSTM warp owns
// hidden unit j and computes gate columns j, H+j, 2H+j, 3H+j for every
// batch row, so its cell update needs no further barrier.
//
// Bound on an H100 SXM: bytes.  Every step reads the decoder weights
// (~18.2 M values: 36.4 MB bf16, 72.8 MB fp32) once; at 3.35 TB/s that is
// ~10.9 us (bf16) / ~21.7 us (fp32) per step, independent of B up to a few
// dozen rows, plus the eight grid barriers.  The bf16 weight set fits the
// 50 MB L2.  The state (h, c, context, prev/cum attention, fed-back mel)
// lives in a small global scratch; the location features come from the
// composed (2K, A) conv+dense matrix, not the TPU kernel's banded matrix
// (10.4 MB at T_enc=128, ~28% more bytes per step).
//
// Numerics follow the JAX package: products take weight-dtype inputs and
// sum in fp32; LSTM cells and everything after qsum stay fp32; qsum is
// rounded to the weight dtype before the fp32 tanh; the context sums
// weight-dtype memory in fp32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

struct DecoderArgs {
  // weights, weight dtype W, PyTorch layout (one row per output)
  const void* pw1;      // (P, M)
  const void* pw2;      // (P, P)
  const void* wi_a;     // (4H, P+E)
  const void* wh_a;     // (4H, H)
  const void* wi_d;     // (4H, H+E)
  const void* wh_d;     // (4H, H)
  const void* wq;       // (A, H)
  const void* wloc;     // (2K, A) composed location conv + dense
  const void* w_heads;  // (M+1, H+E)
  const float* b_a;     // (4H) bias_ih + bias_hh
  const float* b_d;     // (4H)
  const float* b_heads; // (M+1)
  const float* v;       // (A)
  const float* scal;    // (2) v bias, energy scale
  const void* mem;      // (B, T, E) in W
  const float* pm;      // (B, T, A) processed memory
  const uint8_t* mask;  // (B, T) 1 = pad
  // outputs, pre-filled with the post-stop contents by the caller
  float* mels;          // (B, S, M)
  float* gates;         // (B, S)
  float* aligns;        // (B, S, T)
  int* ends;            // (B)
  int* n_frames;        // (1)
  // fp32 scratch, zero-filled by the caller (item_end: S)
  float* h_att;         // (2, B, H) ping-pong by step parity
  float* c_att;         // (B, H)
  float* h_dec;         // (2, B, H)
  float* c_dec;         // (B, H)
  float* ctx;           // (B, E)
  float* prev;          // (B, T)
  float* cum;           // (B, T)
  float* mel;           // (B, M) fed-back frame
  float* p1;            // (B, P)
  float* p2;            // (B, P)
  float* pq;            // (B, A)
  float* energy;        // (B, T)
  int* done;            // (B)
  int* item_end;        // (B)
  int* flags;           // (2) stop, frames out
  int B, T, H, P, E, A, M, K;
  int max_steps, drop_first, stop_all, forced_stop_at;
  float gate_threshold;
  int grid_blocks;      // set by the launcher
};

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

// out[b][j] = relu(dot(rnd(x[b]), w[j])) for j < n_out: one warp per j.
template <typename W>
__device__ void matvec_relu(const W* w, const float* x, float* out, int K,
                            int n_out, int B, int gw, int nw, int lane) {
  for (int j = gw; j < n_out; j += nw) {
    for (int b0 = 0; b0 < B; b0 += kNB) {
      const int nb = min(kNB, B - b0);
      float acc[1][kNB] = {};
      const W* rows[1] = {w + (size_t)j * K};
      warp_dot<W, 1>(acc, rows, x + (size_t)b0 * K, K, K, nb, lane);
      warp_reduce<1>(acc);
      if (lane == 0)
        for (int b = 0; b < nb; ++b)
          out[(size_t)(b0 + b) * n_out + j] = fmaxf(acc[0][b], 0.f);
    }
  }
}

// LSTM phase: warp per hidden unit j; gates from [x1 | x2] @ wi + h @ wh.
template <typename W>
__device__ void lstm_phase(const W* wi, const W* wh, const float* bias,
                           const float* x1, int k1, const float* x2, int k2,
                           const float* h_old, float* h_new, float* c,
                           int H, int B, int gw, int nw, int lane) {
  const int kin = k1 + k2;
  for (int j = gw; j < H; j += nw) {
    for (int b0 = 0; b0 < B; b0 += kNB) {
      const int nb = min(kNB, B - b0);
      float acc[4][kNB] = {};
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
      if (lane < nb) {
        // lane b finishes batch row b0 + b
        float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f;
#pragma unroll
        for (int b = 0; b < kNB; ++b)
          if (b == lane) {
            gi = acc[0][b]; gf = acc[1][b]; gg = acc[2][b]; go = acc[3][b];
          }
        gi += bias[j]; gf += bias[H + j]; gg += bias[2 * H + j];
        go += bias[3 * H + j];
        const size_t idx = (size_t)(b0 + lane) * H + j;
        const float cn = sigmoidf(gf) * __ldcg(c + idx) +
                         sigmoidf(gi) * tanhf(gg);
        c[idx] = cn;
        h_new[idx] = sigmoidf(go) * tanhf(cn);
      }
    }
  }
}

// Block-wide reduction; every thread gets the result.
__device__ float block_reduce(float v, float* red, bool is_max) {
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

template <typename W>
__global__ void __launch_bounds__(kThreads)
decoder_infer_kernel(const DecoderArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int B = a.B, T = a.T, H = a.H, P = a.P, E = a.E, A = a.A, M = a.M,
            K = a.K, S = a.max_steps;
  float* red = smem;                        // kWarps + 1
  float* ctx_red = red + 32;                // kWarps * kCtxCols
  float* attn_s = ctx_red + kWarps * kCtxCols;  // T
  float* gate_s = attn_s + T;               // B
  float* win_all = gate_s + B;              // kWarps * 2K

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const W* pw1 = static_cast<const W*>(a.pw1);
  const W* pw2 = static_cast<const W*>(a.pw2);
  const W* wq = static_cast<const W*>(a.wq);
  const W* wloc = static_cast<const W*>(a.wloc);
  const W* w_heads = static_cast<const W*>(a.w_heads);
  const W* mem = static_cast<const W*>(a.mem);
  const int pad = (K - 1) / 2;
  const int n_iter = a.drop_first ? S + 1 : S;
  const int n_chunks = (E + kCtxCols - 1) / kCtxCols;
  const float v_b = a.scal[0], escale = a.scal[1];

  for (int t = 0; t < n_iter; ++t) {
    grid.sync();
    if (__ldcg(a.flags) != 0) break;
    const int r = a.drop_first ? t - 1 : t;  // recorded row; < 0: none
    const float* h_att_old = a.h_att + (size_t)(t & 1) * B * H;
    float* h_att_new = a.h_att + (size_t)((t + 1) & 1) * B * H;
    const float* h_dec_old = a.h_dec + (size_t)(t & 1) * B * H;
    float* h_dec_new = a.h_dec + (size_t)((t + 1) & 1) * B * H;

    // 1, 2: prenet (eval mode: no dropout)
    matvec_relu<W>(pw1, a.mel, a.p1, M, P, B, gw, nw, lane);
    grid.sync();
    matvec_relu<W>(pw2, a.p1, a.p2, P, P, B, gw, nw, lane);
    grid.sync();

    // 3: attention LSTM on [prenet | context]
    lstm_phase<W>(static_cast<const W*>(a.wi_a), static_cast<const W*>(a.wh_a),
                  a.b_a, a.p2, P, a.ctx, E, h_att_old, h_att_new, a.c_att, H,
                  B, gw, nw, lane);
    grid.sync();

    // 4a: processed query
    for (int j = gw; j < A; j += nw) {
      for (int b0 = 0; b0 < B; b0 += kNB) {
        const int nb = min(kNB, B - b0);
        float acc[1][kNB] = {};
        const W* rows[1] = {wq + (size_t)j * H};
        warp_dot<W, 1>(acc, rows, h_att_new + (size_t)b0 * H, H, H, nb, lane);
        warp_reduce<1>(acc);
        if (lane == 0)
          for (int b = 0; b < nb; ++b) a.pq[(size_t)(b0 + b) * A + j] = acc[0][b];
      }
    }
    grid.sync();

    // 4b: energies, one warp per (b, t_enc)
    {
      float* win = win_all + warp * 2 * K;
      for (int idx = gw; idx < B * T; idx += nw) {
        const int b = idx / T, tt = idx % T;
        for (int i = lane; i < 2 * K; i += 32) {
          const int c = i / K, k = i % K, src = tt + k - pad;
          const float* in = c == 0 ? a.prev : a.cum;
          win[i] = (src >= 0 && src < T)
                       ? rnd<W>(__ldcg(in + (size_t)b * T + src)) : 0.f;
        }
        __syncwarp();
        float e = 0.f;
        for (int j = lane; j < A; j += 32) {
          float loc = 0.f;
          for (int i = 0; i < 2 * K; ++i)
            loc = fmaf(win[i], to_f(wloc[(size_t)i * A + j]), loc);
          const float q = rnd<W>(__ldcg(a.pq + (size_t)b * A + j) +
                                 a.pm[((size_t)b * T + tt) * A + j] + loc);
          e = fmaf(tanhf(q), a.v[j], e);
        }
        e = warp_sum(e);
        if (lane == 0) {
          e = (e + v_b) * escale;
          a.energy[(size_t)b * T + tt] = a.mask[(size_t)b * T + tt] ? -1e9f : e;
        }
        __syncwarp();
      }
    }
    grid.sync();

    // 4c: softmax and context, one block per (b, 32-column chunk of E)
    for (int task = blockIdx.x; task < B * n_chunks; task += gridDim.x) {
      const int b = task / n_chunks, ch = task % n_chunks;
      const float* eb = a.energy + (size_t)b * T;
      float m = -INFINITY;
      for (int i = threadIdx.x; i < T; i += kThreads) m = fmaxf(m, __ldcg(eb + i));
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
          a.prev[o] = w;
          a.cum[o] = __ldcg(a.cum + o) + w;
          if (r >= 0) a.aligns[((size_t)b * S + r) * T + i] = w;
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
        a.ctx[(size_t)b * E + d] = sum;
      }
      __syncthreads();
    }
    grid.sync();

    // 5: decoder LSTM on [h_att | context]
    lstm_phase<W>(static_cast<const W*>(a.wi_d), static_cast<const W*>(a.wh_d),
                  a.b_d, h_att_new, H, a.ctx, E, h_dec_old, h_dec_new, a.c_dec,
                  H, B, gw, nw, lane);
    grid.sync();

    // 6: fused heads; global warp 0 (block 0) takes the gate column and
    // then the stop bookkeeping, published by the next step's grid.sync.
    for (int i = gw; i <= M; i += nw) {
      const int c = i == 0 ? M : i - 1;
      for (int b0 = 0; b0 < B; b0 += kNB) {
        const int nb = min(kNB, B - b0);
        float acc[1][kNB] = {};
        const W* r1[1] = {w_heads + (size_t)c * (H + E)};
        const W* r2[1] = {r1[0] + H};
        warp_dot<W, 1>(acc, r1, h_dec_new + (size_t)b0 * H, H, H, nb, lane);
        warp_dot<W, 1>(acc, r2, a.ctx + (size_t)b0 * E, E, E, nb, lane);
        warp_reduce<1>(acc);
        if (lane == 0) {
          for (int b = 0; b < nb; ++b) {
            const int bb = b0 + b;
            const float out = acc[0][b] + a.b_heads[c];
            if (c < M) {
              a.mel[(size_t)bb * M + c] = out;
              if (r >= 0) a.mels[((size_t)bb * S + r) * M + c] = out;
            } else {
              gate_s[bb] = out;
              if (r >= 0) a.gates[(size_t)bb * S + r] = out;
            }
          }
        }
      }
      if (i == 0 && lane == 0) {
        // decoder_infer's while-loop bookkeeping; the forced stop only
        // counts from the first recorded frame on
        const int n_out = a.drop_first ? t : t + 1;
        int any = 0, all = 1;
        for (int b = 0; b < B; ++b) {
          const bool fired =
              (n_out > 1 && sigmoidf(gate_s[b]) > a.gate_threshold) ||
              (n_out >= 1 && n_out >= a.forced_stop_at);
          const bool was = a.done[b] != 0;
          if (fired && !was) a.item_end[b] = n_out;
          const int now = (was || fired) ? 1 : 0;
          a.done[b] = now;
          any |= now;
          all &= now;
        }
        if (n_out > 0) a.flags[1] = n_out;
        a.flags[0] = a.stop_all ? all : any;
      }
    }
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // same thread that wrote flags/item_end: its own writes are visible
    const int nf = a.flags[1];
    for (int b = 0; b < B; ++b) a.ends[b] = min(a.item_end[b], nf);
    a.n_frames[0] = nf;
  }
}

static size_t smem_bytes(const DecoderArgs& a) {
  return sizeof(float) *
         (32 + kWarps * kCtxCols + a.T + a.B + kWarps * 2 * a.K);
}

template <typename W>
static int launch(DecoderArgs* a, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = smem_bytes(*a);
  auto kern = decoder_infer_kernel<W>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  a->grid_blocks = std::min(per_sm, kMaxBlocksPerSM) * sms;
  void* args[] = {a};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(a->grid_blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Returns a cudaError_t (0 = launched).  bf16 != 0: weights and memory
// are __nv_bfloat16, else float.
extern "C" int t2_decoder_infer(DecoderArgs* a, int bf16, int device,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, device, s)
              : launch<float>(a, device, s);
}

extern "C" int t2_decoder_args_size() { return (int)sizeof(DecoderArgs); }
