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
// (decoder_train_bwd.cu) consumes: the post-dropout hidden states in the
// weight dtype W, the fp32 cell states, the attention pre-tanh sum qsum in
// W (the very values the fp32 tanh consumed), and the LSTM PRE-activation
// gate stacks with their biases in W.
//
// Phases, separated by grid barriers (four a step):
//   before the loop: attention LSTM of step 0
//   loop head       (the barrier after the LSTMs)
//   pq              query projection pq = W_q h_att of step t
//   energies        location features, qsum (stored), energies
//   softmax/context softmax, context, prev/cum
//   decoder LSTM + attention LSTM + heads
//                   the decoder LSTM of step t and the attention LSTM of
//                   step t+1 on the same blocks, the heads of step t-1 on
//                   the blocks that no LSTM tile needs
//   after the loop: the heads of the last step.
// The design before this one had five barriers a step.  One is cut: the
// attention LSTM of step t+1 reads the prenetted frame, the context of
// step t and its own state, all ready once the softmax of step t is, so
// it shares a phase with the decoder LSTM of step t, which reads the same
// context and writes only the decoder state.  The heads of step t-1 read
// the decoder state and the context of step t-1; the context is kept by
// step parity like the hidden states, so they run beside the LSTMs of the
// next step, on blocks that would idle there.  Each remaining barrier
// orders an operand after the phase that writes it.  The previous cell
// state is row t-1 of the stored series.
//
// Bound on an H100 SXM.  With every input read once the floor is the
// products' operations at the bf16 tensor-core rate (0.32 ms for B=16,
// T_dec=512, T_enc=128, above the 0.2-0.3 ms of its bytes).  This design
// keeps no weight on chip between steps, so its own bound is the stream:
// every step re-reads the weights (~18.1 M values: 36.2 MB bf16, 72.4 MB
// fp32) and writes the qsum row (B * T_enc * A values: 0.5 MB bf16 at
// B=16, T_enc=128) and the gate stacks; at 3.35 TB/s the bf16 weight
// stream alone is ~10.8 us per step, 5.5 ms over 512 steps.
//
// Design: the decode kernel's (decoder_infer.cu), with a batch tile of 16.
// The products (both LSTMs' gates, pq, heads) go through product_tile
// (decoder_common.cuh): the wrapper lays every weight matrix out
// tile-major, the LSTMs' [w_ih | w_hh] with their gate rows interleaved so
// that a block's 16 rows are the four gates of four units, two rows a
// warp, and the cell update, the dropout and the stored series are written
// in the same phase from the sums in shared memory.  A block's chunk of
// weights comes by one bulk copy into a ring stage, the operand's batch
// rows by 16-byte cp.async copies onto the same mbarrier, so the operand
// leaves L2 once a block and chunk.  One pass covers up to 16 batch rows,
// so each chunk of weights is copied and widened once a step (a batch above
// 16 takes a pass per 16 rows).  Before each grid barrier a block asks for
// the first weights of its tile of the next product (the decoder LSTM's
// before the two attention phases).  Every state that a product reads
// (the prenetted frame, rounded once by the wrapper, the context and both
// hidden states after dropout) is written in W, rounded once where it is
// produced.  The composed location matrix stays in shared memory for the
// whole launch where it fits a block with the rest (else, at a wide A or a
// long location conv, a lane reads it from L2 in the same order: the same
// sums), and a lane keeps four attention columns' sums in flight.
// The grid barrier is release/acquire on one counter (GridBarrier).
//
// Numerics: every sum is taken in warp_dot's order, operation for
// operation, as the design before this one took it (one warp_dot a segment
// into one accumulator), so all nine outputs are bit for bit its own.  A
// product row is summed as warp_dot sums it: lane l takes the Vec<W>::N
// elements at l * N of every 32 * N of each operand segment (the chunking
// restarts at each segment's start: [pre | ctx | h_att], [h_att | ctx |
// h_dec], [h_dec | ctx]), FMA in k order, then warp_sum, then the bias.
// The rounding to W of a state where it is written gives the value that
// warp_dot's per-element rnd<W> gave.  The energies sum the window in tap
// order and the attention columns in column order; the softmax and context
// are decoder_common.cuh's.  Cell states, energies, prev/cum and pq stay
// fp32; qsum is rounded to W before the fp32 tanh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include "decoder_common.cuh"

struct TrainFwdArgs {
  // weights, weight dtype W, in the wrapper's layout
  const void* w_att;    // (4H, P+E+H) [wi_a | wh_a], row 4j+g = gate g of
                        // unit j, tile-major, 16 rows a tile
  const void* w_dec;    // (4H, H+E+H) [wi_d | wh_d], the same
  const void* wq;       // (A, H) tile-major, 8 rows a tile
  const void* wloc;     // (2K, A) composed location conv + dense
  const void* w_heads;  // (M+1, H+E) tile-major, 8 rows a tile
  const float* b_a;     // (4H) bias_ih + bias_hh, PyTorch gate order
  const float* b_d;     // (4H)
  const float* b_heads; // (M+1)
  const float* v;       // (A)
  const float* scal;    // (2) v bias, energy scale
  const void* mem;      // (B, T, E) in W
  const float* pm;      // (B, T, A) processed memory
  const uint8_t* mask;  // (B, T) 1 = pad
  // streamed inputs
  const void* pre;      // (S, B, P) prenetted frames in W
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
  // scratch, zero-filled by the caller; *_w in W
  void* ctx_w;          // (2, B, E) ping-pong by step parity
  void* h_att_w;        // (2, B, H) ping-pong by step parity
  void* h_dec_w;        // (2, B, H)
  float* prev;          // (B, T)
  float* cum;           // (B, T)
  float* pq;            // (B, A)
  float* energy;        // (B, T)
  unsigned int* bar;    // (1) the grid barrier's arrivals
  int B, T, H, P, E, A, M, K, S;
  float keep_a, keep_d;
  int grid_blocks;      // set by the launcher
};

constexpr int kFwdMTile = 16;   // batch rows of a product's pass

// LSTM phase of step t: gates of the operand against w (rows 4j + g), then
// for every unit of the tile the pre-activations with their bias, rounded
// to W, as row t of pre_s (PyTorch gate order), the new fp32 cell state as
// row t of c_s (the old one is row t-1, zero at t = 0), and the hidden
// state after dropout, in W, to h_new and row t of h_s.
template <typename W>
__device__ void train_lstm_phase(const Product<W, 2>& pr, const float* bias,
                                 W* pre_s, float* c_s, W* h_s, W* h_new,
                                 const uint8_t* mk, float keep, int t, int H,
                                 int B, bool prefetched, Ring& ring,
                                 float* res) {
  const size_t row_t = (size_t)t * B;   // step t's first row of the series
  // the biases, old cells and keep bits of the block's first tile and
  // pass, loaded while the products run (a thread's: batch row idx / 4,
  // unit idx % 4)
  const int idx0 = threadIdx.x, m_0 = idx0 >> 2,
            j_0 = blockIdx.x * 4 + (idx0 & 3);
  float b0[4] = {0.f, 0.f, 0.f, 0.f}, c0 = 0.f, k0 = 1.f;
  if (idx0 < min(B, kFwdMTile) * 4 && j_0 < H) {
#pragma unroll
    for (int q = 0; q < 4; ++q) b0[q] = bias[q * H + j_0];
    if (t > 0) c0 = __ldcg(c_s + (row_t - B + m_0) * H + j_0);
    if (keep < 1.f) k0 = (float)mk[(row_t + m_0) * H + j_0];
  }
  product_phase<kFwdMTile>(pr, B, prefetched, ring, res,
                           [&](int m0, int mrows, int row0,
                               const float* sums) {
    const bool first = m0 == 0 && row0 == (int)blockIdx.x * 2 * kWarps;
    for (int idx = threadIdx.x; idx < mrows * 4; idx += kThreads) {
      const int m = idx >> 2, u = idx & 3, j = row0 / 4 + u;
      const float* s = sums + m * 2 * kWarps + u * 4;
      const size_t row = row_t + m0 + m;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        g[q] = s[q] + (first ? b0[q] : bias[q * H + j]);
        st_w(pre_s + row * 4 * H + (size_t)q * H + j, g[q]);
      }
      const float c_old = first ? c0
                          : t > 0 ? __ldcg(c_s + (row - B) * H + j) : 0.f;
      const float cn = sigmoidf(g[1]) * c_old + sigmoidf(g[0]) * tanhf(g[2]);
      c_s[row * H + j] = cn;
      float hn = sigmoidf(g[3]) * tanhf(cn);
      if (keep < 1.f)
        hn = (hn / keep) * (first ? k0 : (float)mk[row * H + j]);
      st_w(h_new + (size_t)(m0 + m) * H + j, hn);
      st_w(h_s + row * H + j, hn);
    }
  });
}

// Dynamic shared memory, in bytes from its start (16-byte aligned parts).
// The location matrix is resident (wl_resident) where the whole layout
// fits kSmemLimit; else it takes no shared memory and is read from L2, in
// the same order.
struct FwdSmem {
  int res, bars, wl, red, ctx_red, attn_s, win, total;
  bool wl_resident;
};

template <typename W>
__host__ __device__ inline FwdSmem fwd_smem(int T, int A, int K) {
  FwdSmem l;
  l.res = ring_bytes<kFwdMTile>();
  l.bars = l.res + res_bytes<kFwdMTile>();
  l.wl = l.bars + up16(kRingMaxStages * 8);
  const int wl_bytes = up16(2 * K * A * (int)sizeof(W));
  for (int resident = 1; resident >= 0; --resident) {
    l.wl_resident = resident;
    l.red = l.wl + (resident ? wl_bytes : 0);
    l.ctx_red = l.red + up16(32 * 4);
    l.attn_s = l.ctx_red + up16(kWarps * kCtxCols * 4);
    l.win = l.attn_s + up16(T * 4);
    l.total = l.win + up16(kWarps * 2 * K * 4);
    if (l.total <= kSmemLimit) break;
  }
  return l;
}

template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
decoder_train_fwd_kernel(const TrainFwdArgs a) {
  GridBarrier grid = {a.bar, gridDim.x, 0u};
  extern __shared__ __align__(128) char smem[];
  const int B = a.B, T = a.T, H = a.H, P = a.P, E = a.E, A = a.A, M = a.M,
            K = a.K, S = a.S;
  const FwdSmem L = fwd_smem<W>(T, A, K);
  float* res = reinterpret_cast<float*>(smem + L.res);
  W* wl = reinterpret_cast<W*>(smem + L.wl);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* ctx_red = reinterpret_cast<float*>(smem + L.ctx_red);
  float* attn_sm = reinterpret_cast<float*>(smem + L.attn_s);
  float* win_all = reinterpret_cast<float*>(smem + L.win);
  Ring ring = {smem, reinterpret_cast<uint64_t*>(smem + L.bars), 0u};

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const W* mem = static_cast<const W*>(a.mem);
  const W* pre = static_cast<const W*>(a.pre);
  W* ctx_w = static_cast<W*>(a.ctx_w);
  W* h_att_w = static_cast<W*>(a.h_att_w);
  W* h_dec_w = static_cast<W*>(a.h_dec_w);
  W* ha_s = static_cast<W*>(a.ha_s);
  W* hd_s = static_cast<W*>(a.hd_s);
  W* aa_s = static_cast<W*>(a.aa_s);
  W* ad_s = static_cast<W*>(a.ad_s);
  const float v_b = a.scal[0], escale = a.scal[1];
  // the state buffers of step t (t = -1: the zeros), by step parity
  auto h_att = [&](int t) { return h_att_w + (size_t)((t + 1) & 1) * B * H; };
  auto h_dec = [&](int t) { return h_dec_w + (size_t)((t + 1) & 1) * B * H; };
  auto ctx = [&](int t) { return ctx_w + (size_t)((t + 1) & 1) * B * E; };
  auto att_lstm = [&](int t) {
    return Product<W, 2>{{{pre + (size_t)t * B * P, ctx(t - 1), h_att(t - 1)},
                          {P, E, H}, 3},
                         static_cast<const W*>(a.w_att), 4 * H};
  };
  auto dec_lstm = [&](int t) {
    return Product<W, 2>{{{h_att(t), ctx(t), h_dec(t - 1)}, {H, E, H}, 3},
                         static_cast<const W*>(a.w_dec), 4 * H};
  };
  auto query = [&](int t) {
    return Product<W, 1>{{{h_att(t)}, {H}, 1}, static_cast<const W*>(a.wq),
                         A};
  };
  auto heads = [&](int t) {
    return Product<W, 1>{{{h_dec(t), ctx(t)}, {H, E}, 2},
                         static_cast<const W*>(a.w_heads), M + 1};
  };
  auto heads_phase = [&](int t, bool prefetched, int first, int count) {
    matvec_phase<kFwdMTile, false>(heads(t), a.frames + (size_t)t * B *
                                   (M + 1), M + 1, a.b_heads, B, prefetched,
                                   ring, res, first, count);
  };
  // Both LSTMs of a phase deal their tiles to blocks 0 .. n_lstm - 1; the
  // heads of step t-1 go to the blocks after them in the same phase (or,
  // on a grid with none after them, to every block after its LSTM tiles).
  const int grid_n = gridDim.x;
  const int n_lstm = (4 * H + 2 * kWarps - 1) / (2 * kWarps);
  const int h_first = n_lstm < grid_n ? n_lstm : 0;
  const int h_count = grid_n - h_first;
  const int head_tile = (int)blockIdx.x - h_first;

  // the location matrix stays in shared memory for the whole launch
  if (L.wl_resident)
    for (int i = threadIdx.x; i < 2 * K * A; i += kThreads)
      wl[i] = static_cast<const W*>(a.wloc)[i];
  ring_init(ring);
  __syncthreads();

  // the attention LSTM of step 0
  bool pf = prefetch<kFwdMTile>(att_lstm(0), ring), pf_h = false;
  train_lstm_phase<W>(att_lstm(0), a.b_a, aa_s, a.ca_s, ha_s, h_att(0),
                      a.mka, a.keep_a, 0, H, B, pf, ring, res);
  pf = prefetch<kFwdMTile>(query(0), ring);
  for (int t = 0; t < S; ++t) {
    // phase: loop head
    grid.sync();
    // phase: pq
    // then the first weights of the block's decoder-LSTM tile, which the
    // ring holds through the two attention phases, or of its heads tile
    matvec_phase<kFwdMTile, false>(query(t), a.pq, A, nullptr, B, pf, ring,
                                   res);
    pf = prefetch<kFwdMTile>(dec_lstm(t), ring);
    pf_h = !pf && t > 0 &&
           prefetch_tile<kFwdMTile>(heads(t - 1), ring, head_tile);
    grid.sync();
    // phase: energies
    // one warp per (b, t_enc); qsum stored; the location matrix from
    // shared memory, or from L2 where it did not fit
    if (L.wl_resident)
      energies_resident<W>(wl, a.prev, a.cum, a.pq, a.pm, a.v, a.mask, v_b,
                           escale, a.energy,
                           static_cast<W*>(a.qsum_s) + (size_t)t * B * T * A,
                           win_all, B, T, A, K, gw, nw, lane, warp);
    else
      energies_resident<W>(static_cast<const W*>(a.wloc), a.prev, a.cum,
                           a.pq, a.pm, a.v, a.mask, v_b, escale, a.energy,
                           static_cast<W*>(a.qsum_s) + (size_t)t * B * T * A,
                           win_all, B, T, A, K, gw, nw, lane, warp);
    grid.sync();
    // phase: softmax/context
    // one block per (b, 32-column chunk of E)
    softmax_context_phase<W, W>(a.energy, mem, a.prev, a.cum, ctx(t),
                                a.attn_s + (size_t)t * B * T, (size_t)T, red,
                                ctx_red, attn_sm, B, T, E);
    grid.sync();
    // phase: decoder LSTM + attention LSTM + heads
    // the decoder LSTM of step t on [h_att | context], the attention LSTM
    // of step t+1 on [prenet frame | context], the heads of step t-1; then
    // the first weights of pq (of the last heads after the last step)
    train_lstm_phase<W>(dec_lstm(t), a.b_d, ad_s, a.cd_s, hd_s, h_dec(t),
                        a.mkd, a.keep_d, t, H, B, pf, ring, res);
    if (t + 1 < S)
      train_lstm_phase<W>(att_lstm(t + 1), a.b_a, aa_s, a.ca_s, ha_s,
                          h_att(t + 1), a.mka, a.keep_a, t + 1, H, B, false,
                          ring, res);
    if (t > 0) heads_phase(t - 1, pf_h, h_first, h_count);
    pf = prefetch<kFwdMTile>(t + 1 < S ? query(t + 1) : heads(S - 1), ring);
  }
  grid.sync();
  heads_phase(S - 1, pf, 0, 0);
}

// Rows of a weight tile, for the wrapper's layout: 8 for pq and the heads,
// 16 for the LSTMs.
extern "C" int t2_decoder_train_fwd_tile_rows(int lstm) {
  return kWarps * (lstm ? 2 : 1);
}

// Returns a cudaError_t (0 = launched).  bf16 != 0: weights, memory and
// the W-typed series are __nv_bfloat16, else float.
extern "C" int t2_decoder_train_fwd(TrainFwdArgs* a, int bf16, int device,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const TrainFwdArgs) =
      bf16 ? decoder_train_fwd_kernel<__nv_bfloat16>
           : decoder_train_fwd_kernel<float>;
  const size_t smem = bf16 ? fwd_smem<__nv_bfloat16>(a->T, a->A, a->K).total
                           : fwd_smem<float>(a->T, a->A, a->K).total;
  return coop_launch(kern, a, smem, device, s, &a->grid_blocks);
}

// The launch's dynamic shared memory in bytes, negated where the location
// matrix is not resident (ops/decoder_train_kernel.py::fwd_smem mirrors it).
extern "C" int t2_decoder_train_fwd_smem_bytes(int T, int A, int K,
                                               int bf16) {
  const FwdSmem l = bf16 ? fwd_smem<__nv_bfloat16>(T, A, K)
                         : fwd_smem<float>(T, A, K);
  return l.wl_resident ? l.total : -l.total;
}

extern "C" int t2_decoder_train_fwd_args_size() {
  return (int)sizeof(TrainFwdArgs);
}
