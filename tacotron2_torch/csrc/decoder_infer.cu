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
// Each phase needs all of the one before it, so the eight barriers a step
// stay: none can be cut without a block recomputing another's outputs.
//
// Bound on an H100 SXM: bytes.  Every step reads the decoder weights
// (~18.2 M values: 36.4 MB bf16, 72.8 MB fp32) once; at 3.35 TB/s that is
// ~10.9 us (bf16) / ~21.7 us (fp32) per step, independent of B up to a few
// dozen rows, plus the eight grid barriers.  The bf16 weight set fits the
// 50 MB L2.  A step is eight dependent phases, so its time is as much
// latency (barriers, the first bytes of each phase) as bytes.
//
// Design.  The products (prenet, both LSTMs' gates, pq, heads) go through
// product_tile (decoder_common.cuh, in passes of kDecMTile = 8 batch
// rows): one weight row a warp, two in the LSTMs, whose gate rows
// the wrapper interleaves so that a block's 16 rows are the four gates of
// four hidden units and the cell update runs in the same phase from the
// sums in shared memory (256 blocks of the grid's 264 share an LSTM
// phase).  The wrapper lays every weight matrix out tile-major, so that a
// block's K-chunk of weights is one contiguous piece that one thread asks
// the Tensor Memory Accelerator for (a 1-D bulk copy) into a ring stage;
// the operand's batch rows are staged beside it by 16-byte cp.async
// copies spread over the block, so the operand leaves L2 once a block and
// chunk, not once a weight row.  Both complete the stage's mbarrier.
// Before each grid barrier a block asks for the first weights of its tile
// of the next product, which depend on nothing the barrier orders (the
// decoder LSTM's before the two attention phases).  Every state that a
// product reads (fed-back mel, prenet outputs, context, both hidden
// states) is written in the weight dtype W, rounded once where it is
// produced: the value that the JAX package's `.astype(cdt)` (and
// warp_dot's per-element rounding) gives.  The composed (2K, A) location
// matrix stays in shared memory for the whole decode where it fits a
// block with the rest (else, at a wide A or a long location conv, a lane
// reads it from L2 in the same order: the same sums), and a lane keeps
// four attention columns' sums in flight.  The grid barrier is
// release/acquire on one counter (GridBarrier).  The stop bookkeeping
// lives in block 0's shared memory.  The state (c, prev/cum attention, energies, pq) lives in a
// small global scratch; the location features come from the composed
// matrix, not the TPU kernel's banded one (10.4 MB at T_enc=128).
//
// Numerics: every sum is taken in warp_dot's order, operation for
// operation, as the design before this one took it, so the outputs are bit
// for bit its own.  A product row is summed as warp_dot sums it: lane l
// takes the Vec<W>::N elements at l * N of every 32 * N of each operand
// segment (the chunking restarts at each segment's start), FMA in k order,
// then warp_sum, then the bias.  The energies sum the window in tap order
// and the attention columns in column order; the softmax and context are
// decoder_common.cuh's.  Products take W inputs and sum in fp32; LSTM
// cells and everything after qsum stay fp32; qsum is rounded to W before
// the fp32 tanh.
//
// Device code shared with the training kernels is in decoder_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include "decoder_common.cuh"

struct DecoderArgs {
  // weights, weight dtype W, one row per output (the wrapper's layout)
  const void* pw1;      // (P, M)
  const void* pw2;      // (P, P)
  const void* w_att;    // (4H, P+E+H) [wi_a | wh_a], row 4j+g = gate g of j
  const void* w_dec;    // (4H, H+E+H) [wi_d | wh_d], the same row order
  const void* wq;       // (A, H)
  const void* wloc;     // (2K, A) composed location conv + dense
  const void* w_heads;  // (1+M, H+E) gate row, then the projection's
  const float* b_a;     // (4H) bias_ih + bias_hh, PyTorch gate order
  const float* b_d;     // (4H)
  const float* b_heads; // (1+M) gate bias, then the projection's
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
  // scratch, zero-filled by the caller; *_w in W
  void* mel_w;          // (B, M) fed-back frame
  void* p1_w;           // (B, P)
  void* p2_w;           // (B, P)
  void* ctx_w;          // (B, E)
  void* h_att_w;        // (2, B, H) ping-pong by step parity
  void* h_dec_w;        // (2, B, H)
  float* c_att;         // (B, H)
  float* c_dec;         // (B, H)
  float* prev;          // (B, T)
  float* cum;           // (B, T)
  float* pq;            // (B, A)
  float* energy;        // (B, T)
  int* flags;           // (2) stop, frames out
  unsigned int* bar;    // (1) the grid barrier's arrivals
  int B, T, H, P, E, A, M, K;
  int max_steps, drop_first, stop_all, forced_stop_at;
  float gate_threshold;
  int grid_blocks;      // set by the launcher
};

constexpr int kDecMTile = 8;   // batch rows of a product's pass

// LSTM phase: gates of [x1 | x2 | h_old] against w (rows 4j + g), then the
// cell of every unit of the tile; h_new in W.
template <typename W>
__device__ void lstm_phase(const Product<W, 2>& pr, const float* bias,
                           W* h_new, float* c, int H, int B, bool prefetched,
                           Ring& ring, float* res) {
  // the biases and cells of the block's first tile and pass, loaded while
  // the products run (a thread's: batch row idx / 4, unit idx % 4)
  const int idx0 = threadIdx.x, m_0 = idx0 >> 2, j_0 = blockIdx.x * 4 +
                                                        (idx0 & 3);
  float b0[4] = {0.f, 0.f, 0.f, 0.f}, c0 = 0.f;
  if (idx0 < min(B, kDecMTile) * 4 && j_0 < H) {
#pragma unroll
    for (int g = 0; g < 4; ++g) b0[g] = bias[g * H + j_0];
    c0 = __ldcg(c + (size_t)m_0 * H + j_0);
  }
  product_phase<kDecMTile>(pr, B, prefetched, ring, res,
                           [&](int m0, int mrows, int row0,
                               const float* sums) {
    const bool first = m0 == 0 && row0 == (int)blockIdx.x * 2 * kWarps;
    for (int idx = threadIdx.x; idx < mrows * 4; idx += kThreads) {
      const int m = idx >> 2, u = idx & 3, j = row0 / 4 + u;
      const float* g = sums + m * 2 * kWarps + u * 4;
      const size_t ci = (size_t)(m0 + m) * H + j;
      const float gi = g[0] + (first ? b0[0] : bias[j]),
                  gf = g[1] + (first ? b0[1] : bias[H + j]),
                  gg = g[2] + (first ? b0[2] : bias[2 * H + j]),
                  go = g[3] + (first ? b0[3] : bias[3 * H + j]);
      const float cn = sigmoidf(gf) * (first ? c0 : __ldcg(c + ci)) +
                       sigmoidf(gi) * tanhf(gg);
      c[ci] = cn;
      st_w(h_new + ci, sigmoidf(go) * tanhf(cn));
    }
  });
}

// Dynamic shared memory, in bytes from its start (16-byte aligned parts).
// The location matrix is resident (wl_resident) where the whole layout
// fits kSmemLimit; else it takes no shared memory and is read from L2.
struct SmemLayout {
  int res, bars, wl, red, ctx_red, attn_s, gate_s, stop, win, total;
  bool wl_resident;
};

template <typename W>
__host__ __device__ inline SmemLayout smem_layout(int B, int T, int A,
                                                  int K) {
  SmemLayout l;
  l.res = ring_bytes<kDecMTile>();
  l.bars = l.res + res_bytes<kDecMTile>();
  l.wl = l.bars + up16(kRingMaxStages * 8);
  const int wl_bytes = up16(2 * K * A * (int)sizeof(W));
  for (int resident = 1; resident >= 0; --resident) {
    l.wl_resident = resident;
    l.red = l.wl + (resident ? wl_bytes : 0);
    l.ctx_red = l.red + up16(32 * 4);
    l.attn_s = l.ctx_red + up16(kWarps * kCtxCols * 4);
    l.gate_s = l.attn_s + up16(T * 4);
    l.stop = l.gate_s + up16(B * 4);
    l.win = l.stop + up16(2 * B * 4);
    l.total = l.win + up16(kWarps * 2 * K * 4);
    if (l.total <= kSmemLimit) break;
  }
  return l;
}

template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
decoder_infer_kernel(const DecoderArgs a) {
  GridBarrier grid = {a.bar, gridDim.x, 0u};
  extern __shared__ __align__(128) char smem[];
  const int B = a.B, T = a.T, H = a.H, P = a.P, E = a.E, A = a.A, M = a.M,
            K = a.K, S = a.max_steps;
  const SmemLayout L = smem_layout<W>(B, T, A, K);
  float* res = reinterpret_cast<float*>(smem + L.res);
  W* wl = reinterpret_cast<W*>(smem + L.wl);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* ctx_red = reinterpret_cast<float*>(smem + L.ctx_red);
  float* attn_s = reinterpret_cast<float*>(smem + L.attn_s);
  float* gate_s = reinterpret_cast<float*>(smem + L.gate_s);
  int* done_s = reinterpret_cast<int*>(smem + L.stop);   // block 0's
  int* end_s = done_s + B;
  float* win_all = reinterpret_cast<float*>(smem + L.win);
  Ring ring = {smem, reinterpret_cast<uint64_t*>(smem + L.bars), 0u};

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const W* mem = static_cast<const W*>(a.mem);
  W* mel_w = static_cast<W*>(a.mel_w);
  W* p1_w = static_cast<W*>(a.p1_w);
  W* p2_w = static_cast<W*>(a.p2_w);
  W* ctx_w = static_cast<W*>(a.ctx_w);
  W* h_att_w = static_cast<W*>(a.h_att_w);
  W* h_dec_w = static_cast<W*>(a.h_dec_w);
  const int n_iter = a.drop_first ? S + 1 : S;
  const float v_b = a.scal[0], escale = a.scal[1];
  const Product<W, 1> prenet1 = {{{mel_w}, {M}, 1},
                                 static_cast<const W*>(a.pw1), P};
  const Product<W, 1> prenet2 = {{{p1_w}, {P}, 1},
                                 static_cast<const W*>(a.pw2), P};

  // the location matrix stays in shared memory for the whole decode
  if (L.wl_resident)
    for (int i = threadIdx.x; i < 2 * K * A; i += kThreads)
      wl[i] = static_cast<const W*>(a.wloc)[i];
  ring_init(ring);
  if (threadIdx.x == 0) {
    for (int b = 0; b < B; ++b) {
      done_s[b] = 0;
      end_s[b] = S;
    }
  }
  __syncthreads();

  bool pf = prefetch<kDecMTile>(prenet1, ring);
  for (int t = 0; t < n_iter; ++t) {
    // phase: loop head
    grid.sync();
    // phase: prenet 1
    if (__ldcg(a.flags) != 0) break;
    const int r = a.drop_first ? t - 1 : t;  // recorded row; < 0: none
    const W* h_att_old = h_att_w + (size_t)(t & 1) * B * H;
    W* h_att_new = h_att_w + (size_t)((t + 1) & 1) * B * H;
    const W* h_dec_old = h_dec_w + (size_t)(t & 1) * B * H;
    W* h_dec_new = h_dec_w + (size_t)((t + 1) & 1) * B * H;
    const Product<W, 2> att_lstm = {{{p2_w, ctx_w, h_att_old}, {P, E, H}, 3},
                                    static_cast<const W*>(a.w_att), 4 * H};
    const Product<W, 1> query = {{{h_att_new}, {H}, 1},
                                 static_cast<const W*>(a.wq), A};
    const Product<W, 2> dec_lstm = {
        {{h_att_new, ctx_w, h_dec_old}, {H, E, H}, 3},
        static_cast<const W*>(a.w_dec), 4 * H};
    const Product<W, 1> heads = {{{h_dec_new, ctx_w}, {H, E}, 2},
                                 static_cast<const W*>(a.w_heads), M + 1};

    // 1, 2: prenet (eval mode: no dropout).  Before each barrier a block
    // asks for its first weights of the next product.
    matvec_phase<kDecMTile, true>(prenet1, p1_w, P, nullptr, B, pf, ring,
                                  res);
    pf = prefetch<kDecMTile>(prenet2, ring);
    grid.sync();
    // phase: prenet 2
    matvec_phase<kDecMTile, true>(prenet2, p2_w, P, nullptr, B, pf, ring,
                                  res);
    pf = prefetch<kDecMTile>(att_lstm, ring);
    grid.sync();

    // phase: attention LSTM
    // on [prenet | context]
    lstm_phase<W>(att_lstm, a.b_a, h_att_new, a.c_att, H, B, pf, ring, res);
    pf = prefetch<kDecMTile>(query, ring);
    grid.sync();

    // phase: pq
    // the processed query; then the decoder LSTM's first weights, which
    // the ring holds through the two attention phases
    matvec_phase<kDecMTile, false>(query, a.pq, A, nullptr, B, pf, ring,
                                   res);
    pf = prefetch<kDecMTile>(dec_lstm, ring);
    grid.sync();

    // phase: energies
    // one warp per (b, t_enc); the location matrix from shared memory, or
    // from L2 where it did not fit
    if (L.wl_resident)
      energies_resident<W>(wl, a.prev, a.cum, a.pq, a.pm, a.v, a.mask, v_b,
                           escale, a.energy, nullptr, win_all, B, T, A, K,
                           gw, nw, lane, warp);
    else
      energies_resident<W>(static_cast<const W*>(a.wloc), a.prev, a.cum,
                           a.pq, a.pm, a.v, a.mask, v_b, escale, a.energy,
                           nullptr, win_all, B, T, A, K, gw, nw, lane, warp);
    grid.sync();

    // phase: softmax/context
    // one block per (b, 32-column chunk of E)
    softmax_context_phase<W>(
        a.energy, mem, a.prev, a.cum, ctx_w,
        r >= 0 ? a.aligns + (size_t)r * T : nullptr, (size_t)S * T, red,
        ctx_red, attn_s, B, T, E);
    grid.sync();

    // phase: decoder LSTM
    // on [h_att | context]
    lstm_phase<W>(dec_lstm, a.b_d, h_dec_new, a.c_dec, H, B, pf, ring, res);
    pf = prefetch<kDecMTile>(heads, ring);
    grid.sync();

    // phase: heads + stop
    // Row 0 of the heads is the gate's: block 0 takes it, and then the stop
    // bookkeeping (in its shared memory), published by the next step's
    // grid.sync.
    // the bias of a thread's head row in the block's first tile, loaded
    // while the products run
    const int i_0 = blockIdx.x * kWarps + threadIdx.x % kWarps;
    const float hb0 = i_0 <= M ? a.b_heads[i_0] : 0.f;
    product_phase<kDecMTile>(heads, B, pf, ring, res,
                             [&](int m0, int mrows, int row0,
                                 const float* sums) {
      const bool first = row0 == (int)blockIdx.x * kWarps;
      for (int idx = threadIdx.x; idx < mrows * kWarps; idx += kThreads) {
        const int m = idx / kWarps, i = row0 + idx % kWarps, bb = m0 + m;
        if (i > M) continue;
        const float out = sums[m * kWarps + idx % kWarps] +
                          (first ? hb0 : a.b_heads[i]);
        if (i > 0) {
          st_w(mel_w + (size_t)bb * M + i - 1, out);
          if (r >= 0) a.mels[((size_t)bb * S + r) * M + i - 1] = out;
        } else {
          gate_s[bb] = out;
          if (r >= 0) a.gates[(size_t)bb * S + r] = out;
        }
      }
    });
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // decoder_infer's while-loop bookkeeping; the forced stop only
      // counts from the first recorded frame on
      const int n_out = a.drop_first ? t : t + 1;
      int any = 0, all = 1;
      for (int b = 0; b < B; ++b) {
        const bool fired =
            (n_out > 1 && sigmoidf(gate_s[b]) > a.gate_threshold) ||
            (n_out >= 1 && n_out >= a.forced_stop_at);
        const bool was = done_s[b] != 0;
        if (fired && !was) end_s[b] = n_out;
        const int now = (was || fired) ? 1 : 0;
        done_s[b] = now;
        any |= now;
        all &= now;
      }
      if (n_out > 0) a.flags[1] = n_out;
      a.flags[0] = a.stop_all ? all : any;
    }
    pf = prefetch<kDecMTile>(prenet1, ring);
  }
  if (pf) drain<kDecMTile>(prenet1, ring);

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // same thread that wrote flags and end_s: its own writes are visible
    const int nf = a.flags[1];
    for (int b = 0; b < B; ++b) a.ends[b] = min(end_s[b], nf);
    a.n_frames[0] = nf;
  }
}

// Rows of a weight tile, for the wrapper's layout: 8 for the prenet, pq and
// heads, 16 for the LSTMs.
extern "C" int t2_decoder_infer_tile_rows(int lstm) {
  return kWarps * (lstm ? 2 : 1);
}


// Returns a cudaError_t (0 = launched).  bf16 != 0: weights and memory
// are __nv_bfloat16, else float.
extern "C" int t2_decoder_infer(DecoderArgs* a, int bf16, int device,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const DecoderArgs) =
      bf16 ? decoder_infer_kernel<__nv_bfloat16> : decoder_infer_kernel<float>;
  const size_t smem = bf16 ? smem_layout<__nv_bfloat16>(a->B, a->T, a->A,
                                                        a->K).total
                           : smem_layout<float>(a->B, a->T, a->A, a->K).total;
  return coop_launch(kern, a, smem, device, s, &a->grid_blocks);
}

extern "C" int t2_decoder_args_size() { return (int)sizeof(DecoderArgs); }

// The launch's dynamic shared memory in bytes, negated where the location
// matrix is not resident (ops/decoder_megakernel.py::decode_smem mirrors it).
extern "C" int t2_decoder_infer_smem_bytes(int B, int T, int A, int K,
                                           int bf16) {
  const SmemLayout l = bf16 ? smem_layout<__nv_bfloat16>(B, T, A, K)
                            : smem_layout<float>(B, T, A, K);
  return l.wl_resident ? l.total : -l.total;
}
