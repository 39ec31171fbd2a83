// Reverse chain of the split-BPTT decoder backward: the sequential dx chain
// over T_dec steps, from the last to the first, as ONE cooperative launch
// whose time loop runs inside the kernel.
//
// Replaces the Pallas kernel tacotron2_tpu/ops/decoder_bwd_kernel.py::
// decoder_bwd_chain_mega (a reversed time grid with the weights resident in
// TPU VMEM and the gradient carries in scratch).  Per step it re-derives the
// gate activations in fp32 from the streamed PRE-activations and tanh(c_t)
// from the stored cell states (no forward product is recomputed), then runs
// the head, decoder-LSTM, attention (context, softmax, tanh, location,
// query) and attention-LSTM backward.  It carries no weight-gradient
// accumulator: it EMITS the per-step gate gradients, context and prenet
// cotangents, d_qsum and d_pq rows, from which the weight gradients are
// time-batched products outside (ops/decoder_bptt.py).  d_pm, dv and the two
// scalar sums accumulate here.
//
// Every product contracts the OUTPUT dimension of a weight.  The port holds
// weights as (out, in); the wrapper hands this kernel a transposed copy of
// each matrix, made once per call ([wi_d | wh_d] and [wi_a | wh_a] stacked
// into one matrix each), so that the row of one result element is
// contiguous over the contracted dimension.
//
// Phases of step t, separated by grid.sync() (six per step):
//   A  head backward, rnd(d_out) . w_heads; decoder-LSTM gate gradients
//      g_dec (rounded to W, emitted), d_cd carry
//                                    [shares a phase with E of step t+1]
//   B  [d_xd | d_hd] = g_dec . [wi_d | wh_d]; d_ctx complete (emitted)
//   C1 d_attn = d_attn_out + d_prev + d_cum + rnd(d_ctx) . memory
//   C2 softmax backward on the stored row, th = tanh(qsum) from the stored
//      rounded qsum, d_qsum; d_pm += unrounded d_qsum (one owner per
//      element); d_qsum emitted rounded to W; per-block partial sums over
//      the 8 positions of a block for d_pq, dv and the two scalars
//   C3 fixed-order sums of the partials (d_pq emitted, and kept rounded to
//      W for D; dv, scalars accumulated); location backward: d_prev, d_cum
//      from the rounded d_qsum and the composed (2K, A) matrix, a K-tap
//      correlation over rows staged in shared memory, in chunks of A
//      columns where the rows and the matrix do not fit a block at once
//   D  d_ha_att = rnd(d_pq) . wq, attention-LSTM gate gradients g_att
//      (rounded, emitted), d_ca carry
//   E  [d_xa | d_ha] = g_att . [wi_a | wh_a] (d_pre emitted, d_ctx carry)
// Sums that cross blocks use per-block partials and a second pass in a
// fixed order, never float atomics: two runs give the same bits.
//
// The four products A, B, D and E are staged_product (decoder_common.cuh):
// a block takes a run of 8-row weight tiles, stages its operand (written
// once, already rounded to W: the emitted g_dec / g_att row of this step,
// the rounded d_out and d_pq) and its weight rows K-chunk by K-chunk in a
// cp.async ring, and sums each output by FMA in warp_dot's own order, so
// the outputs are bit for bit those of a warp per row reading the operand
// from L2, which cost 1.14 GB of L2 reads a step in B and E at B=16.  Sums
// in another order (the tensor cores' among them) move the bf16 roundings
// of the gate gradients, and the chain carries each moved rounding on;
// the plain version's limits at T_dec=64 leave no room for that (PERF.md).
//
// Bound on an H100 SXM.  With every input read once the floor is the
// products' operations at the bf16 tensor-core rate (0.32 ms for B=16,
// T_dec=512, T_enc=128, above the time of its bytes).  This design keeps no
// weight on chip between steps, so its own bound is the stream: every step
// re-reads the transposed weights (~18.1 M values: 36.2 MB bf16) and the
// qsum row and writes the d_qsum row (0.5 MB each in bf16 at B=16,
// T_enc=128) and the gate-gradient rows; the bf16 weight stream alone is
// ~10.8 us per step at 3.35 TB/s, 5.5 ms over 512 steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tacotron2_torch/ops/_build.py).

#include "decoder_common.cuh"

// A block's shared memory, two blocks an SM: 228 KB less 1 KB reserved
// per block, halved.
constexpr int kSmemPerBlock = (228 - 2) * 1024 / 2;
// The longest location conv phase C3 takes: its staged rows and matrix,
// sized as fp32, take 4 (kWarps + 3 K - 1) bytes a column, and a chunk is
// at least 8 columns (16-byte copies of bf16).
constexpr int kMaxLocTaps =
    (kSmemPerBlock / (4 * 8) - kWarps + 1) / 3;   // 1203

// Columns of A that phase C2 sums at once: all of A where its two
// (kWarps, A) partials fit a block, else the most in whole warps' worth
// (32 columns: a lane's sums keep their order).
__host__ __device__ inline int c2_cols(int A) {
  const int fit = (kSmemPerBlock / 4 - 2 * kWarps) / (2 * kWarps);
  return A <= fit ? A : fit / 32 * 32;
}

// Columns of A that phase C3 stages at once: all of A where the
// kWarps + K - 1 rows and the (2K, A) matrix fit a block (sized as fp32),
// else chunks of a multiple of 8 evened out over A; 0 past kMaxLocTaps.
__host__ __device__ inline int c3_cols(int A, int K) {
  const int fit = kSmemPerBlock / (4 * (kWarps + 3 * K - 1)) / 8 * 8;
  if (fit >= A) return A;
  if (fit < 8) return 0;
  const int chunks = (A + fit - 1) / fit;
  return ((A + chunks - 1) / chunks + 7) / 8 * 8;
}

struct TrainBwdArgs {
  // transposed weights in W: one contiguous row per INPUT of the layer
  const void* w_b;       // (H+E+H, 4H): [wi_d | wh_d] transposed
  const void* w_e;       // (P+E+H, 4H): [wi_a | wh_a] transposed
  const void* wq_t;      // (H, A)
  const void* w_heads_t; // (H+E, MP) zero-padded columns
  const void* wloc;      // (2K, A) composed location conv + dense
  const float* v;        // (A)
  const float* scal;     // (2) v bias, energy scale
  const void* mem;       // (B, T, E) in W
  // streamed inputs (S = T_dec)
  const uint8_t* mka;    // (S, B, H) 1 = keep; unread when keep_a == 1
  const uint8_t* mkd;    // (S, B, H)
  const void* aa_s;      // (S, B, 4H) in W, pre-activations
  const void* ad_s;      // (S, B, 4H) in W
  const float* ca_s;     // (S, B, H)
  const float* cd_s;     // (S, B, H)
  const float* attn_s;   // (S, B, T)
  const void* qsum_s;    // (S, B, T, A) in W
  const void* d_out;     // (S, B, MP) in W, zero-padded columns
  const float* d_attn_out;  // (S, B, T)
  // outputs
  void* g_att_s;         // (S, B, 4H) in W
  void* g_dec_s;         // (S, B, 4H) in W
  float* d_ctx_s;        // (S, B, E)
  float* d_pre_s;        // (S, B, P)
  void* d_qsum_s;        // (S, B, T, A) in W
  float* d_pq_s;         // (S, B, A)
  float* dv;             // (B, A), zero-filled by the caller
  float* dpm;            // (B, T, A), zero-filled by the caller
  float* scal_out;       // (2), zero-filled by the caller
  // fp32 scratch; the carries are zero-filled by the caller
  float* d_ha;           // (B, H) carry
  float* d_ca;           // (B, H) carry
  float* d_hd;           // (B, H) carry
  float* d_cd;           // (B, H) carry
  float* d_ctxn;         // (B, E) carry
  float* d_prev;         // (B, T) carry
  float* d_cum;          // (B, T) carry
  float* d_ha_drop;      // (B, H)
  float* d_ctx_head;     // (B, E) head part of d_ctx
  float* d_ctx;          // (B, E)
  float* d_attn;         // (B, T)
  void* d_pq_w;          // (B, A) in W: this step's rounded d_pq
  float* part_pq;        // (B, NC, A), NC = ceil(T / 8)
  float* part_dv;        // (B, NC, A)
  float* part_sc;        // (B, NC, 2)
  int B, T, H, P, E, A, M, MP, K, S;
  float keep_a, keep_d;
  int grid_blocks;       // set by the launcher
};

// Gate gradients of one LSTM unit at one batch row, from the gradient of
// its hidden state after dropout.  Activations are re-derived in fp32 from
// the rounded PRE-activations, never from rounded outputs, so a saturated
// gate keeps its small derivative factor.  Emits the four gradients rounded
// to W into the emitted row g_out, which the next phase reads back as its
// product's operand, and updates the cell-state carry d_c.
template <typename W>
__device__ __forceinline__ void lstm_gate_grads(
    float d_h_drop, float keep, const uint8_t* mk, const W* pre_row,
    float c_t, float c_prev, float* d_c, W* g_out_row, int H, int j) {
  const float d_h = keep < 1.f ? (d_h_drop / keep) * (float)(*mk) : d_h_drop;
  const float gi = sigmoidf(to_f(pre_row[j]));
  const float gf = sigmoidf(to_f(pre_row[H + j]));
  const float gg = tanhf(to_f(pre_row[2 * H + j]));
  const float go = sigmoidf(to_f(pre_row[3 * H + j]));
  const float tc = tanhf(c_t);
  const float d_o = d_h * tc;
  const float d_cv = __ldcg(d_c) + d_h * go * (1.f - tc * tc);
  const float g[4] = {d_cv * gg * gi * (1.f - gi),
                      d_cv * c_prev * gf * (1.f - gf),
                      d_cv * gi * (1.f - gg * gg),
                      d_o * go * (1.f - go)};
#pragma unroll
  for (int q = 0; q < 4; ++q) st_w(g_out_row + q * H + j, g[q]);
  *d_c = d_cv * gf;
}

template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
decoder_train_bwd_kernel(const TrainBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, P = a.P, E = a.E, A = a.A, MP = a.MP,
            K = a.K, S = a.S;
  const int G = 4 * H;
  const int NC = (T + kWarps - 1) / kWarps;
  const int CA = c2_cols(A);                // C2's columns at once
  float* sm_pq = smem;                      // kWarps * CA
  float* sm_dv = sm_pq + kWarps * CA;       // kWarps * CA
  float* sm_sc = sm_dv + kWarps * CA;       // kWarps * 2
  char* smem_c = reinterpret_cast<char*>(smem);   // A, B, C3, D, E

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const W* w_b = static_cast<const W*>(a.w_b);
  const W* w_e = static_cast<const W*>(a.w_e);
  const W* wq_t = static_cast<const W*>(a.wq_t);
  const W* w_heads_t = static_cast<const W*>(a.w_heads_t);
  const W* d_out = static_cast<const W*>(a.d_out);
  W* d_pq_w = static_cast<W*>(a.d_pq_w);
  const W* wloc = static_cast<const W*>(a.wloc);
  const W* mem = static_cast<const W*>(a.mem);
  const W* aa_s = static_cast<const W*>(a.aa_s);
  const W* ad_s = static_cast<const W*>(a.ad_s);
  const W* qsum_s = static_cast<const W*>(a.qsum_s);
  W* g_att_s = static_cast<W*>(a.g_att_s);
  W* g_dec_s = static_cast<W*>(a.g_dec_s);
  W* d_qsum_s = static_cast<W*>(a.d_qsum_s);
  const float v_b = a.scal[0], escale = a.scal[1];
  const int lpad = (K - 1) / 2;

  for (int t = S - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;

    // A: d_proj = rnd(d_out[t]) . w_heads; columns < H go on through the
    // decoder-LSTM gate gradients, the others are the head part of d_ctx
    {
      const int nt = (H + E) / kTileRows;
      staged_product<W>(
          d_out + tb * MP, B, w_heads_t, MP, blockIdx.x * nt / gridDim.x,
          (blockIdx.x + 1) * nt / gridDim.x, smem_c,
          [&](int bb, int i, float dp) {
            if (i < H) {
              const size_t bi = (size_t)bb * H + i, row = tb + bb;
              lstm_gate_grads<W>(
                  dp + __ldcg(a.d_hd + bi), a.keep_d, a.mkd + row * H + i,
                  ad_s + row * G, a.cd_s[row * H + i],
                  t > 0 ? a.cd_s[(row - B) * H + i] : 0.f, a.d_cd + bi,
                  g_dec_s + row * G, H, i);
            } else {
              a.d_ctx_head[(size_t)bb * E + i - H] = dp;
            }
          });
    }
    grid.sync();

    // B: [d_xd | d_hd] = g_dec . [wi_d | wh_d] (first H columns:
    // d_ha_drop; the next E add to d_ctx; the last H are d_hd)
    {
      const int nt = (2 * H + E) / kTileRows;
      staged_product<W>(
          g_dec_s + tb * G, B, w_b, G, blockIdx.x * nt / gridDim.x,
          (blockIdx.x + 1) * nt / gridDim.x, smem_c,
          [&](int bb, int i, float r) {
            if (i < H) {
              a.d_ha_drop[(size_t)bb * H + i] = r;
            } else if (i < H + E) {
              const size_t o = (size_t)bb * E + i - H;
              const float d =
                  (__ldcg(a.d_ctx_head + o) + __ldcg(a.d_ctxn + o)) + r;
              a.d_ctx[o] = d;
              a.d_ctx_s[(tb + bb) * E + i - H] = d;
            } else {
              a.d_hd[(size_t)bb * H + i - H - E] = r;
            }
          });
    }
    grid.sync();

    // C1: d_attn, one warp per (b, t_enc)
    for (int idx = gw; idx < B * T; idx += nw) {
      const int b = idx / T;
      float acc[1][kNB] = {};
      row_dot<W>(acc, mem + (size_t)idx * E, a.d_ctx + (size_t)b * E, E, E, 1,
                 lane);
      const float dot = warp_sum(acc[0][0]);
      if (lane == 0)
        a.d_attn[idx] = a.d_attn_out[tb * T + idx] + __ldcg(a.d_prev + idx) +
                        __ldcg(a.d_cum + idx) + dot;
    }
    grid.sync();

    // C2: one block per (b, chunk of kWarps positions), one warp per
    // position, lanes over the attention dimension
    for (int task = blockIdx.x; task < B * NC; task += gridDim.x) {
      const int b = task / NC, ch = task % NC;
      const int s = ch * kWarps + warp;
      const bool valid = s < T;
      const float* attn = a.attn_s + (tb + b) * T;
      float sb = 0.f;     // sum over T of attn * d_attn: same bits in every warp
      for (int i = lane; i < T; i += 32)
        sb = fmaf(attn[i], __ldcg(a.d_attn + (size_t)b * T + i), sb);
      sb = warp_sum(sb);
      float d_e = 0.f;
      if (valid) d_e = attn[s] * (__ldcg(a.d_attn + (size_t)b * T + s) - sb);
      const float d_eraw = d_e * escale;
      const size_t po = (size_t)b * NC + ch;
      float e_part = 0.f;
      // A in column chunks of CA (one chunk unless A is very wide)
      for (int j0 = 0; j0 < A; j0 += CA) {
        const int jn = min(CA, A - j0);
        const bool last = j0 + jn == A;
        for (int jj = lane; jj < jn; jj += 32) {
          const int j = j0 + jj;
          float pq_v = 0.f, dv_v = 0.f;
          if (valid) {
            const size_t off = ((tb + b) * T + s) * A + j;
            const float th = tanhf(to_f(qsum_s[off]));
            const float dq = d_eraw * a.v[j] * (1.f - th * th);
            float* pm_acc = a.dpm + ((size_t)b * T + s) * A + j;
            *pm_acc = __ldcg(pm_acc) + dq;
            st_w(d_qsum_s + off, dq);
            pq_v = dq;
            dv_v = th * d_eraw;
            e_part = fmaf(th, a.v[j], e_part);
          }
          sm_pq[warp * CA + jj] = pq_v;
          sm_dv[warp * CA + jj] = dv_v;
        }
        if (last) {
          const float e_raw = warp_sum(e_part);
          if (lane == 0) {
            sm_sc[warp * 2] = valid ? d_e * (e_raw + v_b) : 0.f;
            sm_sc[warp * 2 + 1] = d_e;
          }
        }
        __syncthreads();
        for (int jj = threadIdx.x; jj < jn; jj += kThreads) {
          float sp = 0.f, sd = 0.f;
          for (int w = 0; w < kWarps; ++w) {
            sp += sm_pq[w * CA + jj];
            sd += sm_dv[w * CA + jj];
          }
          a.part_pq[po * A + j0 + jj] = sp;
          a.part_dv[po * A + j0 + jj] = sd;
        }
        if (last && threadIdx.x < 2) {
          float sc = 0.f;
          for (int w = 0; w < kWarps; ++w) sc += sm_sc[w * 2 + threadIdx.x];
          a.part_sc[po * 2 + threadIdx.x] = sc;
        }
        __syncthreads();
      }
    }
    grid.sync();

    // C3: the partials in a fixed order
    for (int i = gtid; i < B * A; i += nthreads) {
      const int b = i / A, j = i % A;
      float sp = 0.f, sd = 0.f;
      for (int ch = 0; ch < NC; ++ch) {
        sp += __ldcg(a.part_pq + ((size_t)b * NC + ch) * A + j);
        sd += __ldcg(a.part_dv + ((size_t)b * NC + ch) * A + j);
      }
      st_w(d_pq_w + i, sp);
      a.d_pq_s[tb * A + i] = sp;
      a.dv[i] = __ldcg(a.dv + i) + sd;
    }
    if (gw == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int i = lane; i < B * NC; i += 32) {
        s0 += __ldcg(a.part_sc + i * 2);
        s1 += __ldcg(a.part_sc + i * 2 + 1);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      if (lane == 0) {
        a.scal_out[0] = __ldcg(a.scal_out) + s0;
        a.scal_out[1] = __ldcg(a.scal_out + 1) + s1;
      }
    }
    // ... and the location backward, one block per (b, kWarps positions),
    // one warp per position:
    // d_prev[b, s'] = sum_{k, j} d_qsum_c[b, s' + lpad - k, j] * wloc[k, j],
    // d_cum likewise with wloc[K + k].  The kWarps + K - 1 rows of d_qsum
    // that the block's taps reach and the composed matrix are staged in
    // shared memory first (16-byte loads), so a row leaves L2 once a block
    // and not once a tap.  Where they do not fit at once (a wide A or a
    // long location conv) they are staged in chunks of CL columns, and a
    // lane carries its two fp32 sums from chunk to chunk; one chunk (the
    // default widths) sums in the order of a whole row.
    {
      constexpr int V = Vec<W>::N;
      const int nr = kWarps + K - 1;
      const int CL = c3_cols(A, K);
      W* rows_s = reinterpret_cast<W*>(smem_c);   // (nr, CL)
      W* wl_s = rows_s + (size_t)nr * CL;         // (2K, CL)
      for (int task = blockIdx.x; task < B * NC; task += gridDim.x) {
        const int b = task / NC, s0 = task % NC * kWarps;
        const int r0 = s0 + lpad - (K - 1);   // first row a tap reaches
        const int sp = s0 + warp;
        float ap = 0.f, ac = 0.f;
        for (int j0 = 0; j0 < A; j0 += CL) {
          const int jn = min(CL, A - j0);     // a multiple of 8
          if (j0 > 0) __syncthreads();        // the last chunk is read
          for (int i = threadIdx.x * V; i < nr * jn; i += kThreads * V) {
            const int r = r0 + i / jn;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r >= 0 && r < T)
              v = __ldcg(reinterpret_cast<const uint4*>(
                  d_qsum_s + ((tb + b) * T + r) * A + j0 + i % jn));
            *reinterpret_cast<uint4*>(rows_s + i) = v;
          }
          for (int i = threadIdx.x * V; i < 2 * K * jn; i += kThreads * V)
            *reinterpret_cast<uint4*>(wl_s + i) =
                __ldg(reinterpret_cast<const uint4*>(
                    wloc + (size_t)(i / jn) * A + j0 + i % jn));
          __syncthreads();
          if (sp < T) {
            for (int k = 0; k < K; ++k) {
              const int s = sp + lpad - k;
              if (s < 0 || s >= T) continue;
              const W* dq = rows_s + (size_t)(s - r0) * jn;
              for (int j = lane; j < jn; j += 32) {
                const float x = widen(dq[j]);
                ap = fmaf(x, widen(wl_s[k * jn + j]), ap);
                ac = fmaf(x, widen(wl_s[(K + k) * jn + j]), ac);
              }
            }
          }
        }
        if (sp < T) {
          ap = warp_sum(ap);
          ac = warp_sum(ac);
          if (lane == 0) {
            const size_t idx = (size_t)b * T + sp;
            a.d_prev[idx] = ap;
            a.d_cum[idx] = __ldcg(a.d_cum + idx) + ac;
          }
        }
        __syncthreads();
      }
    }
    grid.sync();

    // D: d_ha_att = rnd(d_pq) . wq, then the attention-LSTM gate gradients
    {
      const int nt = H / kTileRows;
      staged_product<W>(
          d_pq_w, B, wq_t, A, blockIdx.x * nt / gridDim.x,
          (blockIdx.x + 1) * nt / gridDim.x, smem_c,
          [&](int bb, int i, float r) {
            const size_t bi = (size_t)bb * H + i, row = tb + bb;
            const float d_h =
                (__ldcg(a.d_ha_drop + bi) + r) + __ldcg(a.d_ha + bi);
            lstm_gate_grads<W>(
                d_h, a.keep_a, a.mka + row * H + i, aa_s + row * G,
                a.ca_s[row * H + i], t > 0 ? a.ca_s[(row - B) * H + i] : 0.f,
                a.d_ca + bi, g_att_s + row * G, H, i);
          });
    }
    grid.sync();

    // E: [d_xa | d_ha] = g_att . [wi_a | wh_a] (first P columns: d_pre,
    // emitted; the next E the d_ctx carry; the last H d_ha).  No barrier
    // after it: phase A of the next step reads nothing this phase writes,
    // and the shared memory it leaves is next used after A's barrier.
    {
      const int nt = (P + E + H) / kTileRows;
      staged_product<W>(
          g_att_s + tb * G, B, w_e, G, blockIdx.x * nt / gridDim.x,
          (blockIdx.x + 1) * nt / gridDim.x, smem_c,
          [&](int bb, int i, float r) {
            if (i < P) {
              a.d_pre_s[(tb + bb) * P + i] = r;
            } else if (i < P + E) {
              a.d_ctxn[(size_t)bb * E + i - P] = r;
            } else {
              a.d_ha[(size_t)bb * H + i - P - E] = r;
            }
          });
    }
  }
}

// Phase C2, C3's staging (sized for fp32) and the products use the same
// shared memory in turn.
static size_t smem_bytes(const TrainBwdArgs& a) {
  const size_t c2 = sizeof(float) * (2 * kWarps * c2_cols(a.A) + 2 * kWarps);
  const size_t c3 =
      sizeof(float) * (kWarps + 3 * a.K - 1) * c3_cols(a.A, a.K);
  return std::max(std::max(c2, c3), (size_t)kProductSmemBytes);
}

// Returns a cudaError_t (0 = launched).  bf16 != 0: weights, memory and
// the W-typed series are __nv_bfloat16, else float.  A location conv past
// kMaxLocTaps taps is refused (the wrapper's plan raises first).
extern "C" int t2_decoder_train_bwd(TrainBwdArgs* a, int bf16, int device,
                                    void* stream) {
  if (a->K < 1 || a->K > kMaxLocTaps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const TrainBwdArgs) =
      bf16 ? decoder_train_bwd_kernel<__nv_bfloat16>
           : decoder_train_bwd_kernel<float>;
  return coop_launch(kern, a, smem_bytes(*a), device, s, &a->grid_blocks);
}

extern "C" int t2_decoder_train_bwd_args_size() {
  return (int)sizeof(TrainBwdArgs);
}

extern "C" int t2_decoder_train_bwd_smem_bytes(const TrainBwdArgs* a) {
  return (int)smem_bytes(*a);
}

// Columns of A that phase C3 stages at once (0: the taps are refused).
extern "C" int t2_decoder_train_bwd_c3_cols(int A, int K) {
  return c3_cols(A, K);
}
