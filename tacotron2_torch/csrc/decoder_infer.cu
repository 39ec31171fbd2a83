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
// Device code shared with the training kernels is in decoder_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include "decoder_common.cuh"

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

// LSTM phase: warp per hidden unit j; gates from [x1 | x2] @ wi + h @ wh.
template <typename W>
__device__ void lstm_phase(const W* wi, const W* wh, const float* bias,
                           const float* x1, int k1, const float* x2, int k2,
                           const float* h_old, float* h_new, float* c,
                           int H, int B, int gw, int nw, int lane) {
  for (int j = gw; j < H; j += nw) {
    for (int b0 = 0; b0 < B; b0 += kNB) {
      const int nb = min(kNB, B - b0);
      float acc[4][kNB] = {};
      lstm_gates<W>(acc, wi, wh, x1, k1, x2, k2, h_old, H, j, b0, nb, lane);
      if (lane < nb) {
        // lane b finishes batch row b0 + b
        float g[4];
        pick_row<4>(acc, lane, g);
        const float gi = g[0] + bias[j], gf = g[1] + bias[H + j],
                    gg = g[2] + bias[2 * H + j], go = g[3] + bias[3 * H + j];
        const size_t idx = (size_t)(b0 + lane) * H + j;
        const float cn = sigmoidf(gf) * __ldcg(c + idx) +
                         sigmoidf(gi) * tanhf(gg);
        c[idx] = cn;
        h_new[idx] = sigmoidf(go) * tanhf(cn);
      }
    }
  }
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
  const int n_iter = a.drop_first ? S + 1 : S;
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
    matvec<W, true>(pw1, a.mel, a.p1, M, P, B, gw, nw, lane);
    grid.sync();
    matvec<W, true>(pw2, a.p1, a.p2, P, P, B, gw, nw, lane);
    grid.sync();

    // 3: attention LSTM on [prenet | context]
    lstm_phase<W>(static_cast<const W*>(a.wi_a), static_cast<const W*>(a.wh_a),
                  a.b_a, a.p2, P, a.ctx, E, h_att_old, h_att_new, a.c_att, H,
                  B, gw, nw, lane);
    grid.sync();

    // 4a: processed query
    matvec<W, false>(wq, h_att_new, a.pq, H, A, B, gw, nw, lane);
    grid.sync();

    // 4b: energies, one warp per (b, t_enc)
    energy_phase<W>(wloc, a.prev, a.cum, a.pq, a.pm, a.v, a.mask, v_b, escale,
                    a.energy, static_cast<W*>(nullptr), win_all, B, T, A, K,
                    gw, nw, lane, warp);
    grid.sync();

    // 4c: softmax and context, one block per (b, 32-column chunk of E)
    softmax_context_phase<W>(
        a.energy, mem, a.prev, a.cum, a.ctx,
        r >= 0 ? a.aligns + (size_t)r * T : nullptr, (size_t)S * T, red,
        ctx_red, attn_s, B, T, E);
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

// Returns a cudaError_t (0 = launched).  bf16 != 0: weights and memory
// are __nv_bfloat16, else float.
extern "C" int t2_decoder_infer(DecoderArgs* a, int bf16, int device,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const DecoderArgs) =
      bf16 ? decoder_infer_kernel<__nv_bfloat16> : decoder_infer_kernel<float>;
  return coop_launch(kern, a, smem_bytes(*a), device, s, &a->grid_blocks);
}

extern "C" int t2_decoder_args_size() { return (int)sizeof(DecoderArgs); }
