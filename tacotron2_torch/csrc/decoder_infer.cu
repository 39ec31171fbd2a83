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
// product_tile: one weight row a warp, two in the LSTMs, whose gate rows
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
// matrix stays in shared memory for the whole decode, and a lane keeps
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

// ---------------------------------------------------------------------
// Segmented staged product.  y[b][i] = sum_s x_s[b] . w[i][seg s] for an
// operand given as up to three segments x_s (B, k_s) in W, row-contiguous,
// against weight rows that are the segments' widths laid end to end.  The
// wrapper lays each weight matrix out tile-major, (tiles, chunks, kWarps *
// R rows, 32N elements), each segment zero-padded to whole chunks and the
// rows to whole tiles, so that a block's chunk of weights is one
// contiguous kWarps * R * 512 bytes: one bulk copy (the Tensor Memory
// Accelerator's 1-D form) by one thread into a ring stage; the batch rows'
// pieces are 16-byte cp.async copies spread over the block.  Both complete
// the stage's mbarrier (every thread arrives through cp.async's own
// arrive-on, the weights' bytes through the barrier's transaction count).
// The ring has kDecStages<R> stages: 2 of 16 weight rows (the LSTMs), 3
// of 8, in the same bytes.  (Deeper rings ran no faster on an H100:
// PERF.md.)
// ---------------------------------------------------------------------
constexpr int kDecMTile = 8;             // batch rows per pass
constexpr int kDecRows = 2 * kWarps;     // weight rows of a tile, at most
constexpr int kDecRingBytes = 2 * (kDecRows + kDecMTile) * kChunkBytes;
template <int R> constexpr int kDecStages = R == 1 ? 3 : 2;
constexpr int kDecMaxStages = 3;
constexpr int kDecResBytes = kDecMTile * kDecRows * (int)sizeof(float);

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

// bytes the barrier's current phase waits for, without arriving
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// this thread's arrival, once its cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

template <typename W> struct Operand {
  const W* x[3];
  int k[3];
  int n;
};

// A product: its operand, its tile-major weights (kWarps * R rows a tile)
// and its row count.
template <typename W, int R> struct Product {
  Operand<W> op;
  const W* w;
  int n_rows;
};

// The ring of stages and their barriers; par bit s is the parity that
// stage s's next completion has.  Block-uniform: every thread waits on
// every stage that it reads.
struct Ring {
  char* buf;
  uint64_t* full;
  uint32_t par;
};

// Chunk ch of an operand whose segments have cs0, cs1 chunks: its segment
// s and its chunk c within it (no dynamic indexing of registers).
__device__ __forceinline__ void locate(int ch, int cs0, int cs1, int& s,
                                       int& c) {
  s = 0;
  c = ch;
  if (c >= cs0) {
    c -= cs0;
    s = 1;
    if (c >= cs1) {
      c -= cs1;
      s = 2;
    }
  }
}

template <typename T>
__device__ __forceinline__ T pick3(int s, T a, T b, T c) {
  return s == 0 ? a : (s == 1 ? b : c);
}

// A product's chunk walk: per-segment widths and chunk counts.
template <typename W, int R> struct Walk {
  static constexpr int V = Vec<W>::N;
  static constexpr int CE = 32 * V;          // elements of a chunk
  static constexpr int TR = kWarps * R;      // weight rows of a tile
  static constexpr uint32_t kWBytes = TR * kChunkBytes;
  static constexpr int kStageBytes = (TR + kDecMTile) * kChunkBytes;
  static constexpr int kStages = kDecStages<R>;
  int k0, k1, k2, cs0, cs1, n;
  __device__ explicit Walk(const Operand<W>& op)
      : k0(op.k[0]), k1(op.n > 1 ? op.k[1] : 0), k2(op.n > 2 ? op.k[2] : 0),
        cs0((k0 + CE - 1) / CE), cs1((k1 + CE - 1) / CE),
        n(cs0 + cs1 + (k2 + CE - 1) / CE) {}
  // chunk ch's segment width, its first element in the segment
  __device__ void at(int ch, int& ks, int& e0, int& s) const {
    int c;
    locate(ch, cs0, cs1, s, c);
    ks = pick3(s, k0, k1, k2);
    e0 = c * CE;
  }
};

// The FMAs of batch rows m0 .. m0 + G - 1 of a chunk, loaded and summed
// together so that their sums interleave: acc[r][m] += x[m] . w[r] over the
// lane's piece, in element order.  row_group takes the rows G0 .. G0 +
// kMGroup - 1: in bf16 those that there are (mrows), so that no row past B
// is summed; in fp32 all four once one is (rows past B add into sums that
// are never read), which ran faster there on an H100 (PERF.md).
template <typename W, int R, int G, int m0>
__device__ __forceinline__ void fma_rows(float (&acc)[R][kDecMTile],
                                         const float (&wv)[R][Vec<W>::N],
                                         const char* xp) {
  constexpr int V = Vec<W>::N;
  float xv[G][V];
#pragma unroll
  for (int mm = 0; mm < G; ++mm)
    load_piece<W>(xp + (m0 + mm) * kChunkBytes, xv[mm]);
#pragma unroll
  for (int mm = 0; mm < G; ++mm)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[r][m0 + mm] = fmaf(xv[mm][i], wv[r][i], acc[r][m0 + mm]);
}

template <typename W, int R, int G0>
__device__ __forceinline__ void row_group(float (&acc)[R][kDecMTile],
                                          const float (&wv)[R][Vec<W>::N],
                                          const char* xp, int mrows) {
  static_assert(kMGroup == 4 && G0 + kMGroup <= kDecMTile, "row groups");
  const int left = mrows - G0;
  if constexpr (sizeof(W) == 4) {
    if (left > 0) fma_rows<W, R, 4, G0>(acc, wv, xp);
  } else if (left >= 4)
    fma_rows<W, R, 4, G0>(acc, wv, xp);
  else if (left == 3)
    fma_rows<W, R, 3, G0>(acc, wv, xp);
  else if (left == 2)
    fma_rows<W, R, 2, G0>(acc, wv, xp);
  else if (left == 1)
    fma_rows<W, R, 1, G0>(acc, wv, xp);
}

// Thread 0: tile's weights of chunk ch into stage st.
template <typename W, int R>
__device__ __forceinline__ void issue_weights(const Product<W, R>& pr,
                                              const Walk<W, R>& wk, int tile,
                                              int ch, int st, Ring& ring) {
  mbar_expect(&ring.full[st], wk.kWBytes);
  bulk_copy(ring.buf + st * wk.kStageBytes,
            pr.w + (size_t)(tile * wk.n + ch) * wk.TR * wk.CE, wk.kWBytes,
            &ring.full[st]);
}

// Every thread: its pieces of batch rows m0 .. m0 + mrows - 1 of chunk ch
// into stage st, then its arrival on the stage once they have landed.
template <typename W, int R>
__device__ __forceinline__ void issue_x(const Product<W, R>& pr,
                                        const Walk<W, R>& wk, int ch, int m0,
                                        int mrows, int st, Ring& ring) {
  int ks, e0, s;
  wk.at(ch, ks, e0, s);
  const W* xs = pick3(s, pr.op.x[0], pr.op.x[1], pr.op.x[2]) +
                (size_t)m0 * ks + e0;
  const int pieces = min(wk.CE, ks - e0) / wk.V;
  char* dst = ring.buf + st * wk.kStageBytes + wk.TR * kChunkBytes;
  for (int p = threadIdx.x; p < mrows * 32; p += kThreads) {
    const int m = p >> 5, q = p & 31;
    if (q < pieces)
      cp_async16(dst + m * kChunkBytes + q * 16,
                 xs + (size_t)m * ks + q * wk.V);
  }
  mbar_arrive_after_copies(&ring.full[st]);
}

// Before a grid barrier: the first chunks of weights of the block's first
// tile of the next product, which depend on nothing the barrier orders.
// Returns whether it issued them (block-uniform).
template <typename W, int R>
__device__ bool prefetch(const Product<W, R>& pr, Ring& ring) {
  const Walk<W, R> wk(pr.op);
  if (blockIdx.x >= (pr.n_rows + wk.TR - 1) / wk.TR) return false;
  if (threadIdx.x == 0)
    for (int ch = 0; ch < min(wk.kStages - 1, wk.n); ++ch)
      issue_weights(pr, wk, blockIdx.x, ch, ch, ring);
  return true;
}

// A prefetch that no product takes (the decode stopped): let its stages
// complete before the block exits.
template <typename W, int R>
__device__ void drain(const Product<W, R>& pr, Ring& ring) {
  const Walk<W, R> wk(pr.op);
  const int n = min(wk.kStages - 1, wk.n);
  for (int st = 0; st < n; ++st) mbar_arrive(&ring.full[st]);
  for (int st = 0; st < n; ++st) {
    mbar_wait(&ring.full[st], (ring.par >> st) & 1u);
    ring.par ^= 1u << st;
  }
}

// The block's product for weight rows [tile * kWarps * R, + kWarps * R)
// (warp w on rows w * R .. w * R + R - 1 of the tile), all B batch rows in
// passes of kDecMTile; after each pass the sums are in res[m * kWarps * R
// + row in tile] and epi(m0, mrows, row0, res) runs on the whole block.
// Called by the whole block; `prefetched`: prefetch() issued this tile's
// first weights.  Each sum is warp_dot's over the segments in order: chunk
// c of segment s is elements [c * 32N, (c + 1) * 32N) of it, lane l its N
// elements at l * N (lanes past a ragged end add nothing), FMA in k order;
// then warp_sum.  Every k_s is a multiple of N and every pointer 16-byte
// aligned (the wrapper checks the widths).  x is state that this kernel
// wrote before the last grid barrier: cp.async.cg reads it from L2.
template <typename W, int R, typename Epi>
__device__ void product_tile(const Product<W, R>& pr, int B, int tile,
                             bool prefetched, Ring& ring, float* res,
                             Epi epi) {
  constexpr int V = Vec<W>::N;
  const Walk<W, R> wk(pr.op);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * wk.TR;
  for (int m0 = 0; m0 < B; m0 += kDecMTile) {
    const int mrows = min(kDecMTile, B - m0);
    const bool pre = prefetched && m0 == 0;
    // chunk ch, weights and batch rows, into stage ch % kStages
    auto issue = [&](int ch, bool weights) {
      const int st = ch % wk.kStages;
      if (weights && threadIdx.x == 0)
        issue_weights(pr, wk, tile, ch, st, ring);
      issue_x(pr, wk, ch, m0, mrows, st, ring);
    };
    for (int ch = 0; ch < min(wk.kStages - 1, wk.n); ++ch) issue(ch, !pre);
    float acc[R][kDecMTile];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < kDecMTile; ++m) acc[r][m] = 0.f;
    for (int ch = 0; ch < wk.n; ++ch) {
      if (ch > 0) __syncthreads();      // stage (ch - 1) % kStages is free
      if (ch + wk.kStages - 1 < wk.n) issue(ch + wk.kStages - 1, true);
      const int st = ch % wk.kStages;
      mbar_wait(&ring.full[st], (ring.par >> st) & 1u);
      ring.par ^= 1u << st;
      int ks, e0, s;
      wk.at(ch, ks, e0, s);
      if (lane * V < ks - e0) {
        const char* sp = ring.buf + st * wk.kStageBytes + lane * 16;
        float wv[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r)
          load_piece<W>(sp + (warp * R + r) * kChunkBytes, wv[r]);
        const char* xp = sp + wk.TR * kChunkBytes;
        row_group<W, R, 0>(acc, wv, xp, mrows);
        row_group<W, R, kMGroup>(acc, wv, xp, mrows);
      }
    }
#pragma unroll
    for (int m = 0; m < kDecMTile; ++m) {
      if (m < mrows) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = warp_sum(acc[r][m]);
          if (lane == 0) res[m * wk.TR + warp * R + r] = v;
        }
      }
    }
    __syncthreads();
    epi(m0, mrows, row0, static_cast<const float*>(res));
    __syncthreads();   // the ring and res are reused by the next pass
  }
}

// Every tile of a product, tiles dealt over the blocks.
template <typename W, int R, typename Epi>
__device__ __forceinline__ void product_phase(const Product<W, R>& pr, int B,
                                              bool prefetched, Ring& ring,
                                              float* res, Epi epi) {
  const int n_tiles = (pr.n_rows + kWarps * R - 1) / (kWarps * R);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    product_tile<W, R>(pr, B, tile, prefetched && tile == (int)blockIdx.x,
                       ring, res, epi);
}

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
  product_phase<W, 2>(pr, B, prefetched, ring, res,
                      [&](int m0, int mrows, int row0, const float* sums) {
    const bool first = m0 == 0 && row0 == (int)blockIdx.x * kDecRows;
    for (int idx = threadIdx.x; idx < mrows * 4; idx += kThreads) {
      const int m = idx >> 2, u = idx & 3, j = row0 / 4 + u;
      const float* g = sums + m * kDecRows + u * 4;
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

// out[b][j] = x[b] . w[j] for j < n_rows (RELU: clamped at 0), in O.
template <typename W, bool RELU, typename O>
__device__ void matvec_phase(const Product<W, 1>& pr, O* out, int B,
                             bool prefetched, Ring& ring, float* res) {
  const int n_out = pr.n_rows;
  product_phase<W, 1>(pr, B, prefetched, ring, res,
                      [&](int m0, int mrows, int row0, const float* sums) {
    for (int idx = threadIdx.x; idx < mrows * kWarps; idx += kThreads) {
      const int m = idx / kWarps, j = row0 + idx % kWarps;
      if (j < n_out) {
        const float y = sums[m * kWarps + idx % kWarps];
        st_w(out + (size_t)(m0 + m) * n_out + j, RELU ? fmaxf(y, 0.f) : y);
      }
    }
  });
}

// Location-sensitive energies, one warp per (b, t_enc):
//   q = rnd(pq[b] + pm[b, t] + [prev | cum] window . wloc)
//   energy[b, t] = mask ? -1e9 : (tanh(q) . v + v_b) * escale
// wl: the composed (2K, A) matrix in shared memory; a lane sums its
// columns j = lane + 32q four at a time, each over the window in tap
// order, and tanh(q) . v in column order.  win_all: kWarps * 2K floats of
// shared memory.
template <typename W>
__device__ void energies_resident(const W* wl, const float* prev,
                                  const float* cum, const float* pq,
                                  const float* pm, const float* v,
                                  const uint8_t* mask, float v_b,
                                  float escale, float* energy, float* win_all,
                                  int B, int T, int A, int K, int gw, int nw,
                                  int lane, int warp) {
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
    for (int j0 = lane; j0 < A; j0 += 4 * 32) {
      float loc[4] = {0.f, 0.f, 0.f, 0.f};
      float base[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q;
        base[q] = j < A ? __ldcg(pq + (size_t)b * A + j) +
                              pm[((size_t)b * T + tt) * A + j]
                        : 0.f;
      }
      for (int i = 0; i < 2 * K; ++i) {
        const float x = win[i];
        const W* row = wl + (size_t)i * A + j0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + 32 * q < A) loc[q] = fmaf(x, to_f(row[32 * q]), loc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q;
        if (j < A) e = fmaf(tanhf(rnd<W>(base[q] + loc[q])), v[j], e);
      }
    }
    e = warp_sum(e);
    if (lane == 0) {
      e = (e + v_b) * escale;
      energy[(size_t)b * T + tt] = mask[(size_t)b * T + tt] ? -1e9f : e;
    }
    __syncwarp();
  }
}

// Dynamic shared memory, in bytes from its start (16-byte aligned parts).
struct SmemLayout {
  int res, bars, wl, red, ctx_red, attn_s, gate_s, stop, win, total;
};

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }

template <typename W>
__host__ __device__ inline SmemLayout smem_layout(int B, int T, int A,
                                                  int K) {
  SmemLayout l;
  l.res = kDecRingBytes;
  l.bars = l.res + kDecResBytes;
  l.wl = l.bars + up16(kDecMaxStages * 8);
  l.red = l.wl + up16(2 * K * A * (int)sizeof(W));
  l.ctx_red = l.red + up16(32 * 4);
  l.attn_s = l.ctx_red + up16(kWarps * kCtxCols * 4);
  l.gate_s = l.attn_s + up16(T * 4);
  l.stop = l.gate_s + up16(B * 4);
  l.win = l.stop + up16(2 * B * 4);
  l.total = l.win + up16(kWarps * 2 * K * 4);
  return l;
}

// The grid barrier: every block's thread 0 adds one to a counter that only
// grows (zeroed by the caller) with release semantics, after the block's
// __syncthreads, and waits with acquire loads until it holds gridDim.x
// arrivals for every barrier so far; then the block's __syncthreads.  The
// cooperative launch keeps every block resident.  (cg::grid_group::sync
// fences with __threadfence on both sides; release and acquire are enough
// here, and cost less: PERF.md has the times.)
struct GridBarrier {
  unsigned int* count;
  unsigned int n, target;
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += n;
      unsigned int old, cur;
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(count)
                   : "memory");
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(cur)
                     : "l"(count)
                     : "memory");
      } while ((int)(cur - target) < 0);
    }
    __syncthreads();
  }
};

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
  for (int i = threadIdx.x; i < 2 * K * A; i += kThreads)
    wl[i] = static_cast<const W*>(a.wloc)[i];
  if (threadIdx.x == 0) {
    for (int st = 0; st < kDecMaxStages; ++st)
      mbar_init(&ring.full[st], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < B; ++b) {
      done_s[b] = 0;
      end_s[b] = S;
    }
  }
  __syncthreads();

  bool pf = prefetch(prenet1, ring);
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
    matvec_phase<W, true>(prenet1, p1_w, B, pf, ring, res);
    pf = prefetch(prenet2, ring);
    grid.sync();
    // phase: prenet 2
    matvec_phase<W, true>(prenet2, p2_w, B, pf, ring, res);
    pf = prefetch(att_lstm, ring);
    grid.sync();

    // phase: attention LSTM
    // on [prenet | context]
    lstm_phase<W>(att_lstm, a.b_a, h_att_new, a.c_att, H, B, pf, ring, res);
    pf = prefetch(query, ring);
    grid.sync();

    // phase: pq
    // the processed query; then the decoder LSTM's first weights, which
    // the ring holds through the two attention phases
    matvec_phase<W, false>(query, a.pq, B, pf, ring, res);
    pf = prefetch(dec_lstm, ring);
    grid.sync();

    // phase: energies
    // one warp per (b, t_enc)
    energies_resident<W>(wl, a.prev, a.cum, a.pq, a.pm, a.v, a.mask, v_b,
                         escale, a.energy, win_all, B, T, A, K, gw, nw, lane,
                         warp);
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
    pf = prefetch(heads, ring);
    grid.sync();

    // phase: heads + stop
    // Row 0 of the heads is the gate's: block 0 takes it, and then the stop
    // bookkeeping (in its shared memory), published by the next step's
    // grid.sync.
    // the bias of a thread's head row in the block's first tile, loaded
    // while the products run
    const int i_0 = blockIdx.x * kWarps + threadIdx.x % kWarps;
    const float hb0 = i_0 <= M ? a.b_heads[i_0] : 0.f;
    product_phase<W, 1>(heads, B, pf, ring, res,
                        [&](int m0, int mrows, int row0, const float* sums) {
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
    pf = prefetch(prenet1, ring);
  }
  if (pf) drain(prenet1, ring);

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
