// WaveGlow's WN layer for Hopper (sm_90a): the elementwise work of one
// layer in two passes, the gate and the residual and skip adds, each with
// the biases of the products before it folded in.
//
// Replaces no TPU kernel: the JAX package has no WaveGlow.  It was added
// for ROADMAP.md's item D9.  The three products of a layer (in_layers[i],
// the conditioning's slice of cond_layer, res_skip_layers[i]) run in
// cuDNN without their biases (models/waveglow.py::_wn); before, PyTorch
// ran the layer's elementwise work as nine passes (three bias adds after
// the products, the conditioning's add, tanh and sigmoid on channel
// slices, the gate's product, the residual and skip adds), each reading
// what the one before it had written.
//
//   t2_wn_gate       a = (p + b_in) + (q + b_cond)             (B, 2C, N)
//                    g = tanh(a[:, :C]) * sigmoid(a[:, C:])    (B, C, N)
//   t2_wn_res_skip   r' = r + b
//                    below the last layer (r has 2C channels):
//                      x += r'[:, :C]; skip = r'[:, C:] on the first layer,
//                      else skip += r'[:, C:]
//                    the last layer (r has C channels): skip += r'
//
// Each operation in fp32 as PyTorch's CUDA kernels form it (tanhf;
// 1 / (1 + expf(-a)); the sums in the order above), and each intermediate
// rounded to the tensors' type where one of those passes stored it, so the
// result is theirs bit for bit (ops/waveglow_kernel.py holds the plain
// versions).  No fast-math flag is given (ops/_build.py), and no product
// is followed by a sum, so nothing contracts into an FMA.  x and skip are
// updated in place: they are the WN's own buffers, nothing else holds them.
//
// What bounds it on an H100: bytes.  A few operations a value against
// 16 to 24 bytes.  At the benchmark's batch (B=64, 512 frames: N = 16384
// groups, C = 512, fp32) the gate reads p and q (4.29 GB each) and writes
// g (2.15 GB): 10.7 GB; the residual and skip pass reads r (4.29 GB) and
// reads and writes x and skip (2.15 GB each): 12.9 GB.  A layer is 23.6
// GB, 7.1 ms at 3.35 TB/s; the first (skip written, not read) 21.5 GB and
// the last (r and skip of C channels, x untouched) 17.2 GB.  The passes
// they replace moved about 67 GB a layer.
//
// The design: a grid-stride loop over tiles of THREADS * V positions of
// one channel row (b, c) of the output; a thread takes V consecutive
// positions with one 16-byte load from each input row (V = 4 fp32, 8
// bf16) and one 16-byte store, neighbouring threads on neighbouring
// addresses.  The two channel halves are addressed through the strides
// the wrapper passes (no copy).  A row's last tile is masked where N is no
// multiple of V; where a pointer or a stride does not keep every row on
// 16 bytes, a second build of each kernel takes one value a thread
// (V = 1).  fp32 and bf16 (loads and stores in the type, arithmetic in
// fp32).  No shared memory, no atomics: two launches give the same bits.
//
// Plain C interface (ctypes): each entry point returns a CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr long long MAX_TILES = 1LL << 30;  // the loop's index is 32 bits

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch stores
}

// A value as a PyTorch pass of type T stores it.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// 16 bytes of one load or store, and the values in them.
union Raw {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    return r.f[i];
  }
  static __device__ __forceinline__ void put(Raw& r, int i, float v) {
    r.f[i] = v;
  }
};
template <>
struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    return __bfloat162float(__ushort_as_bfloat16(r.h[i]));
  }
  static __device__ __forceinline__ void put(Raw& r, int i, float v) {
    r.h[i] = __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

// n (1..V) values from p into out (zero past n): one 16-byte load where
// the build is the vector one and the tile is whole.
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, int n,
                                     float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    if (n == V) {
      Raw raw;
      raw.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = Bits<T>::get(raw, i);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = i < n ? to_float(p[i]) : 0.0f;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, int n,
                                      const float (&in)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    if (n == V) {
      Raw raw;
#pragma unroll
      for (int i = 0; i < V; ++i) Bits<T>::put(raw, i, in[i]);
      *reinterpret_cast<uint4*>(p) = raw.u;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i < n) p[i] = from_float<T>(in[i]);
  }
}

struct Tile {
  int b, c, n0, n;  // row (b, c), first position, positions taken (0: none)
};

// Tile t of the loop: rows of B * C channels, tiles_per_row tiles a row.
template <int V>
__device__ __forceinline__ Tile tile_of(unsigned t, unsigned tiles_per_row,
                                        int C, int N) {
  const unsigned row = t / tiles_per_row;
  const int n0 = (int)(t - row * tiles_per_row) * (THREADS * V) +
                 (int)threadIdx.x * V;
  const int b = (int)(row / (unsigned)C);
  const int left = N - n0;
  return {b, (int)row - b * C, n0, left <= 0 ? 0 : (left < V ? left : V)};
}

struct GateArgs {
  const void* p;
  const void* q;
  const void* b_in;
  const void* b_cond;
  void* g;
  long long p_sb, p_sc, q_sb, q_sc, g_sb, g_sc;  // batch, channel strides
  int C, N;                                      // g's channels, positions
  unsigned tiles, tiles_per_row;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) wn_gate_kernel(GateArgs a) {
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ b_in = static_cast<const T*>(a.b_in);
  const T* __restrict__ b_cond = static_cast<const T*>(a.b_cond);
  T* __restrict__ g = static_cast<T*>(a.g);
  for (unsigned t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile k = tile_of<V>(t, a.tiles_per_row, a.C, a.N);
    if (k.n == 0) continue;
    // the tanh half is channel c of a, the sigmoid half channel C + c
    const T* pt = p + k.b * a.p_sb + k.c * a.p_sc + k.n0;
    const T* qt = q + k.b * a.q_sb + k.c * a.q_sc + k.n0;
    float p_t[V], p_s[V], q_t[V], q_s[V];
    load<T, V>(pt, k.n, p_t);
    load<T, V>(pt + a.C * a.p_sc, k.n, p_s);
    load<T, V>(qt, k.n, q_t);
    load<T, V>(qt + a.C * a.q_sc, k.n, q_s);
    const float bi_t = to_float(b_in[k.c]), bi_s = to_float(b_in[a.C + k.c]);
    const float bc_t = to_float(b_cond[k.c]);
    const float bc_s = to_float(b_cond[a.C + k.c]);
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // a = (p + b_in) + (q + b_cond): each bias add, then the sum, stored
      const float a_t =
          rnd<T>(rnd<T>(p_t[i] + bi_t) + rnd<T>(q_t[i] + bc_t));
      const float a_s =
          rnd<T>(rnd<T>(p_s[i] + bi_s) + rnd<T>(q_s[i] + bc_s));
      const float th = rnd<T>(tanhf(a_t));
      const float sg = rnd<T>(1.0f / (1.0f + expf(-a_s)));
      out[i] = th * sg;
    }
    store<T, V>(g + k.b * a.g_sb + k.c * a.g_sc + k.n0, k.n, out);
  }
}

struct ResSkipArgs {
  const void* r;
  const void* bias;
  void* x;
  void* skip;
  long long r_sb, r_sc, x_sb, x_sc, s_sb, s_sc;  // batch, channel strides
  int C, N;            // x's and skip's channels, positions
  int residual;        // r has 2C channels: x += r'[:, :C]
  int accumulate;      // skip holds the sum so far: skip += r'
  unsigned tiles, tiles_per_row;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) wn_res_skip_kernel(ResSkipArgs a) {
  const T* __restrict__ r = static_cast<const T*>(a.r);
  const T* __restrict__ bias = static_cast<const T*>(a.bias);
  T* __restrict__ x = static_cast<T*>(a.x);
  T* __restrict__ skip = static_cast<T*>(a.skip);
  for (unsigned t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile k = tile_of<V>(t, a.tiles_per_row, a.C, a.N);
    if (k.n == 0) continue;
    // skip's part of r is channel C + c below the last layer, else c
    const int cs = a.residual ? a.C + k.c : k.c;
    const T* rb = r + k.b * a.r_sb + k.n0;
    T* sp = skip + k.b * a.s_sb + k.c * a.s_sc + k.n0;
    float r_s[V], s[V];
    load<T, V>(rb + cs * a.r_sc, k.n, r_s);
    if (a.accumulate) load<T, V>(sp, k.n, s);
    if (a.residual) {
      T* xp = x + k.b * a.x_sb + k.c * a.x_sc + k.n0;
      float r_x[V], xv[V];
      load<T, V>(rb + k.c * a.r_sc, k.n, r_x);
      load<T, V>(xp, k.n, xv);
      const float b_x = to_float(bias[k.c]);
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = xv[i] + rnd<T>(r_x[i] + b_x);
      store<T, V>(xp, k.n, xv);
    }
    const float b_s = to_float(bias[cs]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float rv = rnd<T>(r_s[i] + b_s);
      s[i] = a.accumulate ? s[i] + rv : rv;
    }
    store<T, V>(sp, k.n, s);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 1;
  }
  return n < 1 ? 1 : n;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Tiles of a (B, C, N) output at V positions a thread; false where the
// 32-bit loop index would not hold them.
bool plan(int B, int C, int N, int V, unsigned* tiles,
          unsigned* tiles_per_row) {
  const long long per_row = (N + (long long)THREADS * V - 1) /
                            ((long long)THREADS * V);
  const long long n = (long long)B * C * per_row;
  if (n > MAX_TILES) return false;
  *tiles = (unsigned)n;
  *tiles_per_row = (unsigned)per_row;
  return true;
}

template <typename Args, typename T, int V>
int launch(void (*kernel)(Args), Args a, int B, int C, int N,
           cudaStream_t stream) {
  if (!plan(B, C, N, V, &a.tiles, &a.tiles_per_row)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long most = (long long)sm_count() * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(a.tiles < most ? a.tiles : most);
  void* args[] = {&a};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                       dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int gate(GateArgs a, int B, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned(a.p) && aligned(a.q) && aligned(a.g) &&
                   a.p_sb % V == 0 && a.p_sc % V == 0 && a.q_sb % V == 0 &&
                   a.q_sc % V == 0 && a.g_sb % V == 0 && a.g_sc % V == 0;
  return vec ? launch<GateArgs, T, V>(wn_gate_kernel<T, V>, a, B, a.C, a.N,
                                      stream)
             : launch<GateArgs, T, 1>(wn_gate_kernel<T, 1>, a, B, a.C, a.N,
                                      stream);
}

template <typename T>
int res_skip(ResSkipArgs a, int B, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned(a.r) && aligned(a.x) && aligned(a.skip) &&
                   a.r_sb % V == 0 && a.r_sc % V == 0 && a.x_sb % V == 0 &&
                   a.x_sc % V == 0 && a.s_sb % V == 0 && a.s_sc % V == 0;
  return vec ? launch<ResSkipArgs, T, V>(wn_res_skip_kernel<T, V>, a, B, a.C,
                                         a.N, stream)
             : launch<ResSkipArgs, T, 1>(wn_res_skip_kernel<T, 1>, a, B, a.C,
                                         a.N, stream);
}

}  // namespace

// p, q (B, 2C, N) and b_in, b_cond (2C,), g (B, C, N) output; each row of
// positions contiguous, the batch and channel strides given in elements.
// bf16: every tensor bf16, else every tensor fp32.  Launches on `stream`,
// does not synchronise.  Returns the CUDA error code (0 = ok).
extern "C" int t2_wn_gate(const void* p, const void* q, const void* b_in,
                          const void* b_cond, void* g, int bf16, int B,
                          int C, int N, long long p_sb, long long p_sc,
                          long long q_sb, long long q_sc, long long g_sb,
                          long long g_sc, void* stream) {
  if (B < 1 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  GateArgs a{p, q, b_in, b_cond, g, p_sb, p_sc, q_sb, q_sc, g_sb, g_sc,
             C, N, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? gate<__nv_bfloat16>(a, B, s) : gate<float>(a, B, s);
}

// r (B, 2C or C, N) and bias (its channels,); x and skip (B, C, N), each
// row of positions contiguous, strides in elements.  residual: r has 2C
// channels and x += r'[:, :C]; accumulate: skip += r'[:, C:] (or r'), else
// skip is written.  x is not touched where residual is 0.  bf16 as
// t2_wn_gate.  Launches on `stream`, does not synchronise.  Returns the
// CUDA error code (0 = ok).
extern "C" int t2_wn_res_skip(const void* r, const void* bias, void* x,
                              void* skip, int bf16, int B, int C, int N,
                              int residual, int accumulate, long long r_sb,
                              long long r_sc, long long x_sb, long long x_sc,
                              long long s_sb, long long s_sc, void* stream) {
  if (B < 1 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  ResSkipArgs a{r,    bias, x, skip,     r_sb,       r_sc, x_sb, x_sc,
                s_sb, s_sc, C, N,        residual, accumulate, 0, 0};
  if (!residual) {  // x unused: keep it out of the alignment test
    a.x = skip;
    a.x_sb = s_sb;
    a.x_sc = s_sc;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? res_skip<__nv_bfloat16>(a, B, s) : res_skip<float>(a, B, s);
}
