// Teacher-forced decoder forward for training: T_dec decoder steps as ONE
// cooperative launch whose time loop runs inside the kernel.
//
// Replaces the Pallas kernel tacotron2_tpu/ops/decoder_train_kernel.py::
// decoder_fwd_train_mega (whose grid is the time axis, with all weights
// resident in TPU VMEM).  Per step, from the already-prenetted frame:
// attention LSTM, dropout by a streamed 0/1 mask, location-sensitive
// attention through the composed (2K, A) conv+dense matrix, softmax,
// context, decoder LSTM, dropout, fused projection + gate head.  Besides
// the frames and alignments it stores what the reverse-chain kernel
// (decoder_train_bwd.cu) consumes: the post-dropout hidden states rounded
// to the weight dtype W, the fp32 cell states, the attention pre-tanh sum
// qsum rounded to W (the very values the fp32 tanh consumed), and the LSTM
// PRE-activation gate stacks rounded to W.
//
// Phases of step t, separated by grid.sync() (five per step):
//   1 heads of step t-1, attention-LSTM gates + cell of step t
//   2 query projection pq = W_q h_att      4 softmax, context, prev/cum
//   3 location features, qsum, energies    5 decoder-LSTM gates + cell
// and the heads of the last step after the loop.  The heads of step t-1
// read only the decoder hidden state and the context of step t-1, which
// phase 1 of step t does not write, so they share a phase.  The hidden
// state that is carried is the one AFTER dropout, double-buffered by step
// parity; the previous cell state is row t-1 of the stored series.
//
// Bound on an H100 SXM.  With every input read once the floor is the
// products' operations at the bf16 tensor-core rate (0.32 ms for B=16,
// T_dec=512, T_enc=128, above the 0.2-0.3 ms of its bytes).  This design
// keeps no weight on chip between steps, so its own bound is the stream:
// every step re-reads the weights (~18.1 M values: 36.2 MB bf16, 72.4 MB
// fp32) and writes the qsum row (B * T_enc * A values: 0.5 MB bf16 at
// B=16, T_enc=128) and the gate stacks; at 3.35 TB/s the bf16 weight
// stream alone is ~10.8 us per step, 5.5 ms over 512 steps.
// The qsum stream (T_dec * B * T_enc * A) is written once, coalesced over
// A, and no second copy is kept.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include "decoder_common.cuh"

struct TrainFwdArgs {
  // weights, weight dtype W, PyTorch layout (one row per output)
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
  // streamed inputs
  const float* pre;     // (S, B, P) prenetted frames
  const uint8_t* mka;   // (S, B, H) 1 = keep; unread when keep_a == 1
  const uint8_t* mkd;   // (S, B, H)
  // outputs
  float* frames;        // (S, B, M+1)
  float* attn_s;        // (S, B, T)
  void* ha_s;           // (S, B, H) in W, after dropout
  float* ca_s;          // (S, B, H)
  void* hd_s;           // (S, B, H) in W, after dropout
  float* cd_s;          // (S, B, H)
  void* qsum_s;         // (S, B, T, A) in W
  void* aa_s;           // (S, B, 4H) in W, pre-activations + biases
  void* ad_s;           // (S, B, 4H) in W
  // fp32 scratch, zero-filled by the caller
  float* h_att;         // (2, B, H) ping-pong by step parity
  float* h_dec;         // (2, B, H)
  float* ctx;           // (B, E)
  float* prev;          // (B, T)
  float* cum;           // (B, T)
  float* pq;            // (B, A)
  float* energy;        // (B, T)
  int B, T, H, P, E, A, M, K, S;
  float keep_a, keep_d;
  int grid_blocks;      // set by the launcher
};

// LSTM phase of step t: warp per hidden unit j.  Stores the pre-activations
// (with bias) rounded to W, the new fp32 cell state as row t of c_s (the old
// one is row t-1, zero at t = 0) and the hidden state after dropout, fp32 in
// h_new and rounded to W in h_s.
template <typename W>
__device__ void lstm_train_phase(const W* wi, const W* wh, const float* bias,
                                 const float* x1, int k1, const float* x2,
                                 int k2, const float* h_old, float* h_new,
                                 float* c_s, W* h_s, W* pre_s,
                                 const uint8_t* mk, float keep, int t, int H,
                                 int B, int gw, int nw, int lane) {
  for (int j = gw; j < H; j += nw) {
    for (int b0 = 0; b0 < B; b0 += kNB) {
      const int nb = min(kNB, B - b0);
      float acc[4][kNB] = {};
      lstm_gates<W>(acc, wi, wh, x1, k1, x2, k2, h_old, H, j, b0, nb, lane);
      if (lane < nb) {
        // lane b finishes batch row b0 + b
        float g[4];
        pick_row<4>(acc, lane, g);
        const size_t row = (size_t)t * B + b0 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          g[q] += bias[q * H + j];
          st_w(pre_s + row * 4 * H + (size_t)q * H + j, g[q]);
        }
        const size_t idx = (size_t)(b0 + lane) * H + j;
        const float c_old = t > 0 ? __ldcg(c_s + (row - B) * H + j) : 0.f;
        const float cn = sigmoidf(g[1]) * c_old + sigmoidf(g[0]) * tanhf(g[2]);
        c_s[row * H + j] = cn;
        float hn = sigmoidf(g[3]) * tanhf(cn);
        if (keep < 1.f) hn = (hn / keep) * (float)mk[row * H + j];
        h_new[idx] = hn;
        st_w(h_s + row * H + j, hn);
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
decoder_train_fwd_kernel(const TrainFwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int B = a.B, T = a.T, H = a.H, P = a.P, E = a.E, A = a.A, M = a.M,
            K = a.K, S = a.S;
  float* red = smem;                        // kWarps + 1
  float* ctx_red = red + 32;                // kWarps * kCtxCols
  float* attn_sm = ctx_red + kWarps * kCtxCols;  // T
  float* win_all = attn_sm + T;             // kWarps * 2K

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const W* wq = static_cast<const W*>(a.wq);
  const W* wloc = static_cast<const W*>(a.wloc);
  const W* w_heads = static_cast<const W*>(a.w_heads);
  const W* mem = static_cast<const W*>(a.mem);
  const float v_b = a.scal[0], escale = a.scal[1];

  // fused heads of step t: frames[t] = [h_dec | ctx] @ w_heads^T + b_heads
  auto heads = [&](int t, const float* h_dec) {
    for (int c = gw; c <= M; c += nw) {
      for (int b0 = 0; b0 < B; b0 += kNB) {
        const int nb = min(kNB, B - b0);
        float acc[1][kNB] = {};
        const W* row = w_heads + (size_t)c * (H + E);
        row_dot<W>(acc, row, h_dec + (size_t)b0 * H, H, H, nb, lane);
        row_dot<W>(acc, row + H, a.ctx + (size_t)b0 * E, E, E, nb, lane);
        warp_reduce<1>(acc);
        if (lane == 0)
          for (int b = 0; b < nb; ++b)
            a.frames[((size_t)t * B + b0 + b) * (M + 1) + c] =
                acc[0][b] + a.b_heads[c];
      }
    }
  };

  for (int t = 0; t < S; ++t) {
    const float* h_att_old = a.h_att + (size_t)(t & 1) * B * H;
    float* h_att_new = a.h_att + (size_t)((t + 1) & 1) * B * H;
    const float* h_dec_old = a.h_dec + (size_t)(t & 1) * B * H;
    float* h_dec_new = a.h_dec + (size_t)((t + 1) & 1) * B * H;

    // 1: heads of the step before, then the attention LSTM on
    // [prenet frame | context]
    if (t > 0) heads(t - 1, h_dec_old);
    lstm_train_phase<W>(
        static_cast<const W*>(a.wi_a), static_cast<const W*>(a.wh_a), a.b_a,
        a.pre + (size_t)t * B * P, P, a.ctx, E, h_att_old, h_att_new, a.ca_s,
        static_cast<W*>(a.ha_s), static_cast<W*>(a.aa_s), a.mka, a.keep_a, t,
        H, B, gw, nw, lane);
    grid.sync();

    // 2: processed query
    matvec<W, false>(wq, h_att_new, a.pq, H, A, B, gw, nw, lane);
    grid.sync();

    // 3: qsum (stored) and energies, one warp per (b, t_enc)
    energy_phase<W>(wloc, a.prev, a.cum, a.pq, a.pm, a.v, a.mask, v_b, escale,
                    a.energy,
                    static_cast<W*>(a.qsum_s) + (size_t)t * B * T * A, win_all,
                    B, T, A, K, gw, nw, lane, warp);
    grid.sync();

    // 4: softmax and context, one block per (b, 32-column chunk of E)
    softmax_context_phase<W>(a.energy, mem, a.prev, a.cum, a.ctx,
                             a.attn_s + (size_t)t * B * T, (size_t)T, red,
                             ctx_red, attn_sm, B, T, E);
    grid.sync();

    // 5: decoder LSTM on [h_att | context]
    lstm_train_phase<W>(
        static_cast<const W*>(a.wi_d), static_cast<const W*>(a.wh_d), a.b_d,
        h_att_new, H, a.ctx, E, h_dec_old, h_dec_new, a.cd_s,
        static_cast<W*>(a.hd_s), static_cast<W*>(a.ad_s), a.mkd, a.keep_d, t,
        H, B, gw, nw, lane);
    grid.sync();
  }
  heads(S - 1, a.h_dec + (size_t)(S & 1) * B * H);
}

static size_t smem_bytes(const TrainFwdArgs& a) {
  return sizeof(float) * (32 + kWarps * kCtxCols + a.T + kWarps * 2 * a.K);
}

// Returns a cudaError_t (0 = launched).  bf16 != 0: weights, memory and
// the W-typed series are __nv_bfloat16, else float.
extern "C" int t2_decoder_train_fwd(TrainFwdArgs* a, int bf16, int device,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const TrainFwdArgs) =
      bf16 ? decoder_train_fwd_kernel<__nv_bfloat16>
           : decoder_train_fwd_kernel<float>;
  return coop_launch(kern, a, smem_bytes(*a), device, s, &a->grid_blocks);
}

extern "C" int t2_decoder_train_fwd_args_size() {
  return (int)sizeof(TrainFwdArgs);
}
