// The implicit adjoint's damped iteration for Hopper (sm_90a), bound
// through ctypes.
//
// Replaces no TPU kernel. The reference runs this loop as a lax.while_loop
// in plain XLA (tcgan_tpu/ops/ift.py::_bwd, the "iterative" method). It is
// added because the port's eager loop (tcgan_torch/ops/ift.py) issues about
// 12 PyTorch ops an iteration, ~3,450 launches in a fit step at N=51, and
// the host's time to issue them, not the device's work, set the step.
//
// What it computes, per circuit c (S rows of 2N neurons), with lam0 = g:
//
//   delta = -lam + (phi * lam) W_c + g,   lam <- lam + alpha * delta
//
// the update applied only where the circuit's group is active. Groups are
// contiguous runs of P circuits (the group_axes leading axes of the batch).
// Stop mode (the device's stop test): every group runs the first
// iteration; a group stops after the first iteration whose max |delta|
// over its circuits is below atol or is NaN, or at max_iter. Count mode
// (the host's stop test under a split over ranks): group k runs its first
// counts[k] iterations, and each iteration's max |delta| per group may be
// recorded for the host's all-reduce.
//
// The arithmetic is the eager loop's in T (float or double): the product
// phi * lam rounded, the mat-vec as FFMA chains (no TF32: the port's fp32
// matmul runs in full fp32), then (-lam + y) + g and lam + alpha * delta
// each rounded as the eager ops round them. Only the mat-vec's summation
// order differs from cuBLAS's.
//
// What bounds it. 2 S (2N)^2 FLOP a circuit an iteration in fp32 FFMA:
// 333 kFLOP at S=16, 2N=102; the fit's 256 circuits and ~277 iterations are
// 23.6 GFLOP, 0.35 ms at the H100's 67 TFLOP/s fp32 peak outside the tensor
// cores. Device-memory traffic is W, phi, g and lam once, ~12 MB (3.6 us
// at 3.35 TB/s), so the bound is the arithmetic. What sets an iteration's
// time is latency: a thread's chain of 102 k-steps at one warp a
// scheduler, then the block's reduction, not the card's FFMA rate
// (PERF.md has the times).
//
// Design. One persistent cooperative launch (cudaLaunchCooperativeKernel),
// its grid sized by the occupancy query. On the resident path (the fit's
// and the ensemble's shapes) a block holds K circuits: each circuit's W in
// shared memory (rows padded to ld = round_up(2N, 4)) with two planes of
// phi * lam, transposed, this iteration's and the next's; each thread owns
// one 4 x 4 tile of one circuit's outputs (rows x neurons) and keeps its
// lam, phi, g and alpha in registers for the whole loop. An iteration is a
// 4-wide vector of W and one of phi * lam per k-step, loaded a k-step
// ahead, into 16 independent FFMA chains, the update in registers, and the
// tile's new phi * lam written into the other plane: nothing of the state
// touches device memory but at a chunk's start. Each circuit's max |delta|
// is reduced in the block and atomic-maxed, as an integer (a non-negative
// float orders as its bits; a NaN's bits order above +inf, so a NaN wins
// and stops its group, as amax and >= do), into the iteration's slot of
// its group. The stop test needs every block's max of an iteration, so the
// resident path runs kChunk iterations between grid barriers as if no
// group stopped, lam at the chunk's start kept in the output; after the
// barrier every block reads the chunk's slots and takes the same decision,
// and a circuit whose group stopped inside the chunk is replayed from that
// start to its stop (the same arithmetic, so the result is the one an
// iteration-by-iteration test gives). Slots go in a ring of three chunks,
// each reset two chunks ahead, so one barrier a chunk suffices. Where a
// circuit's W and planes do not fit a block's shared memory (2N beyond
// ~220 in fp32 at S=16), its tiles a block's threads, or the batch the
// co-resident blocks, W, lam, phi and g stay in device memory (the
// kWShared = false instantiation): each block walks its circuits, staging
// phi * lam in shared memory an iteration and reading W through L2 at every
// k-step, one barrier an iteration; the arithmetic is the same.

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 4;          // a thread's outputs: kTile rows x kTile neurons
constexpr int kRing = 3;          // chunks of stop-test slots in flight
constexpr int kChunk = 8;         // iterations the resident path runs between grid barriers
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Bits = int;
  __device__ static __forceinline__ Bits bits(float x) { return __float_as_int(fabsf(x)); }
  __device__ static __forceinline__ float value(Bits b) { return __int_as_float(b); }
  __device__ static __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  __device__ static __forceinline__ void load4(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  }
  __device__ static __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Num<double> {
  using Bits = long long;
  __device__ static __forceinline__ Bits bits(double x) { return __double_as_longlong(fabs(x)); }
  __device__ static __forceinline__ double value(Bits b) { return __longlong_as_double(b); }
  __device__ static __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  __device__ static __forceinline__ void load4(const double* p, double* out) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  }
  __device__ static __forceinline__ void store4(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
};

template <typename T>
struct Args {
  using Bits = typename Num<T>::Bits;
  const T* W;            // (nW, n2, n2)
  const int* w_index;    // (C,) W's matrix of each circuit; null: circuit c has W[c]
  const T* phi;          // (C, S, n2)
  const T* g;            // (C, S, n2)
  const T* alpha;        // (n2,)
  const T* lam0;         // (C, S, n2)
  T* lam;                // (C, S, n2)
  int C, P, G, S, n2;    // circuits, circuits per group, groups, rows, neurons
  int Sp, ld, K;         // S and n2 rounded up to kTile; circuits a block holds
  int max_iter;
  T atol;
  Bits* slots;           // stop mode: (kRing, kChunk, G) scratch
  int* iters;            // stop mode: (G,) iterations each group ran
  int* iters_max;        // stop mode: (1,) the slowest group's
  const int* counts;     // count mode: (G,) iterations each group runs; null: stop mode
  Bits* norms;           // count mode: (max_iter, G) zeroed, or null
};

template <typename Bits>
__device__ __forceinline__ Bits load_fresh(const Bits* p) {
  return *reinterpret_cast<const volatile Bits*>(p);
}

template <typename Bits>
__device__ __forceinline__ Bits warp_max(Bits v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Threads a block may have: every thread of the resident path keeps three
// 4 x 4 tiles of T in registers (255 registers at 256 threads for double).
template <typename T>
constexpr int max_threads() {
  return sizeof(T) == 4 ? 512 : 256;
}

// acc = plT[:, s0:s0+4]^T W[:, j0:j0+4] over the n2 rows (plT's rows of
// stride ldp): 16 FFMA chains, each k-step's operands loaded during the
// previous k-step's products.
template <typename T, bool kWShared>
__device__ __forceinline__ void tile_product(const T* W, int ldw, const T* plT, int ldp, int n2,
                                             int s0, int j0, T (&acc)[kTile][kTile]) {
  using N = Num<T>;
  auto load = [&](int i, T (&w)[kTile], T (&p)[kTile]) {
    if constexpr (kWShared) {
      N::load4(W + (size_t)i * ldw + j0, w);
    } else {
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        w[q] = j0 + q < n2 ? __ldg(W + (size_t)i * ldw + j0 + q) : T(0);
    }
    N::load4(plT + i * ldp + s0, p);
  };
  auto step = [&](const T (&w)[kTile], const T (&p)[kTile]) {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[r][q] = N::fma(p[r], w[q], acc[r][q]);
  };
#pragma unroll
  for (int r = 0; r < kTile; ++r)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[r][q] = T(0);
  T wa[kTile], pa[kTile], wb[kTile], pb[kTile];
  load(0, wa, pa);
  int i = 0;
  for (; i + 1 < n2; i += 2) {
    load(i + 1, wb, pb);
    step(wa, pa);
    if (i + 2 < n2) load(i + 2, wa, pa);
    step(wb, pb);
  }
  if (i < n2) step(wa, pa);
}

// A thread's tile t of a circuit's outputs: 4 rows from s0, 4 neurons from
// j0, the rows' tiles fastest (at S=16 a warp's loads of W and of phi *
// lam each span one 128-byte line, and its 4-wide stores of phi * lam
// conflict at most two ways).
struct TileAt {
  int s0, j0;
  __device__ TileAt(int t, int Sp) : s0((t % (Sp / kTile)) * kTile), j0((t / (Sp / kTile)) * kTile) {}
};

// The device-memory path: one iteration of circuit c, every thread of the
// block walking the circuit's tiles, lam, phi and g in device memory, phi *
// lam staged in the block's plane plT; the circuit's max |delta| (as bits)
// returned to thread 0.
template <typename T>
__device__ typename Num<T>::Bits walk_circuit(const Args<T>& a, int c, const T* Wc, T* plT,
                                              typename Num<T>::Bits* red) {
  using N = Num<T>;
  using Bits = typename N::Bits;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n2 = a.n2, S = a.S, Sp = a.Sp, rows = S * n2;
  const size_t off = (size_t)c * rows;
  const T* phic = a.phi + off;
  const T* gc = a.g + off;
  T* lamc = a.lam + off;
  for (int e = tid; e < Sp * n2; e += nt) {  // padded rows of S zero
    const int s = e / n2, i = e - s * n2;
    plT[i * Sp + s] = s < S ? N::mul(__ldg(phic + e), lamc[e]) : T(0);
  }
  __syncthreads();
  const int tiles = (Sp / kTile) * (a.ld / kTile);
  Bits mx = 0;
  for (int t = tid; t < tiles; t += nt) {
    const TileAt at(t, Sp);
    T acc[kTile][kTile];
    tile_product<T, false>(Wc, n2, plT, Sp, n2, at.s0, at.j0, acc);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int s = at.s0 + r;
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int j = at.j0 + q;
        if (s < S && j < n2) {
          const size_t e = (size_t)s * n2 + j;
          const T l = lamc[e];
          const T d = N::add(N::add(-l, acc[r][q]), __ldg(gc + e));
          lamc[e] = N::add(l, N::mul(__ldg(a.alpha + j), d));
          mx = max(mx, N::bits(d));
        }
      }
    }
  }
  mx = warp_max(mx);
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0)
    for (int w = 1; w < (nt + 31) / 32; ++w) mx = max(mx, red[w]);
  return mx;
}

// A resident thread's state: its circuit's slot k in the block and its
// tile, with the tile's lam, phi, g and alpha in registers.
template <typename T>
struct Resident {
  int k, s0, j0;
  bool mine;     // the thread holds a tile of a circuit of the batch
  size_t off;    // the circuit's offset in (C, S, n2)
  T lam[kTile][kTile], phi[kTile][kTile], g[kTile][kTile], alpha[kTile];
};

// phi * lam of the thread's tile into plane P (rows of stride Sp, padded
// rows zero), one 4-wide store a neuron.
template <typename T>
__device__ __forceinline__ void store_plane(const Args<T>& a, const Resident<T>& st, T* P) {
  using N = Num<T>;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (st.j0 + q >= a.n2) break;
    T v[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) v[r] = N::mul(st.phi[r][q], st.lam[r][q]);
    N::store4(P + (size_t)(st.j0 + q) * a.Sp + st.s0, v);
  }
}

// One resident iteration `it` of the thread's tile where `run`: the product
// from plane it & 1 of its circuit's phi * lam, lam updated in registers,
// phi * lam written into the other plane; where `dst`, the circuit's max
// |delta| atomic-maxed into dst[group] through red (two planes of K, by
// parity). Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void resident_iteration(const Args<T>& a, int it, bool run,
                                                   Resident<T>& st, const T* Wk, T* plk,
                                                   typename Num<T>::Bits* red, const int* live,
                                                   typename Num<T>::Bits* dst) {
  using N = Num<T>;
  using Bits = typename N::Bits;
  const size_t psize = (size_t)a.n2 * a.Sp;
  Bits mx = 0;
  if (run) {
    T acc[kTile][kTile];
    tile_product<T, true>(Wk, a.ld, plk + (it & 1) * psize, a.Sp, a.n2, st.s0, st.j0, acc);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const T d = N::add(N::add(-st.lam[r][q], acc[r][q]), st.g[r][q]);
        st.lam[r][q] = N::add(st.lam[r][q], N::mul(st.alpha[q], d));
        if (st.s0 + r < a.S && st.j0 + q < a.n2) mx = max(mx, N::bits(d));
      }
    store_plane(a, st, plk + (~it & 1) * psize);
  }
  if (dst) {
    // the circuit's max: a warp at once where it holds one circuit
    Bits* rd = red + (it & 1) * a.K;
    const int tid = threadIdx.x, k = st.k;
    const int k0 = __shfl_sync(0xffffffffu, k, 0), k31 = __shfl_sync(0xffffffffu, k, 31);
    if (k0 == k31) {
      mx = warp_max(mx);
      if ((tid & 31) == 0 && run) atomicMax(rd + k, mx);
    } else if (run) {
      atomicMax(rd + k, mx);
    }
    __syncthreads();
    for (int kk = tid; kk < a.K; kk += blockDim.x)
      if (live[kk]) {
        atomicMax(dst + ((int)blockIdx.x + kk * (int)gridDim.x) / a.P, rd[kk]);
        rd[kk] = 0;
      }
  } else {
    __syncthreads();
  }
}

// kWShared (the resident path): a block holds K circuits, each W in shared
// memory with two planes of phi * lam (this iteration's and the next's),
// and each thread one circuit's tile, its lam, phi, g and alpha in
// registers for the whole loop; under the device's stop test it runs
// kChunk iterations between grid barriers, as if no group stopped, and a
// circuit whose group stopped inside the chunk is replayed from the
// chunk's start (lam kept in the output) to its stop. Otherwise (the
// device-memory path): W, lam, phi and g in device memory, the block
// walking its K circuits, one barrier an iteration.
template <typename T, bool kWShared>
__global__ void __launch_bounds__(max_threads<T>()) ift_adjoint_kernel(const Args<T> a) {
  using N = Num<T>;
  using Bits = typename N::Bits;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n2 = a.n2, S = a.S, Sp = a.Sp, ld = a.ld, K = a.K;
  const int tiles = (Sp / kTile) * (ld / kTile);
  const size_t wsize = (size_t)n2 * ld, psize = (size_t)n2 * Sp;
  // resident: Ws [K][n2][ld], plT [K][2][n2][Sp], red [2][K];
  // else plT [n2][Sp], red [32]; then live, stopj [K], replay [1]
  T* Ws = reinterpret_cast<T*>(smem_raw);
  T* plT = Ws + (kWShared ? K * wsize : 0);
  Bits* red = reinterpret_cast<Bits*>(plT + (kWShared ? 2 * K * psize : psize));
  int* live = reinterpret_cast<int*>(red + (kWShared ? 2 * K : 32));
  int* stopj = live + K;
  int* replay = stopj + K;
  const bool stop = a.counts == nullptr;
  const int chunk = kWShared ? kChunk : 1;
  auto circuit = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto w_of = [&](int c) { return a.W + (size_t)(a.w_index ? a.w_index[c] : c) * n2 * n2; };

  Resident<T> st;
  st.k = tid / tiles;
  {
    const TileAt at(tid - st.k * tiles, Sp);
    st.s0 = at.s0, st.j0 = at.j0;
  }
  st.mine = kWShared && st.k < K && circuit(st.k) < a.C;
  st.off = (size_t)circuit(st.k) * S * n2;
  const int k = st.k;
  T* plk = plT + 2 * (size_t)k * psize;  // the thread's circuit's planes
  auto in_tile = [&](int r, int q) { return st.s0 + r < S && st.j0 + q < n2; };
  auto at_e = [&](int r, int q) { return st.off + (size_t)(st.s0 + r) * n2 + st.j0 + q; };
  auto store_lam = [&]() {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        if (in_tile(r, q)) a.lam[at_e(r, q)] = st.lam[r][q];
  };
  auto load_lam = [&](const T* src) {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q) st.lam[r][q] = in_tile(r, q) ? src[at_e(r, q)] : T(0);
  };
  if constexpr (kWShared) {
    for (int kk = 0; kk < K && circuit(kk) < a.C; ++kk) {
      const T* Wc = w_of(circuit(kk));
      for (int e = tid; e < n2 * ld; e += nt) {
        const int i = e / ld, j = e - i * ld;
        Ws[kk * wsize + e] = j < n2 ? __ldg(Wc + (size_t)i * n2 + j) : T(0);
      }
    }
    for (int e = tid; e < 2 * K; e += nt) red[e] = 0;
#pragma unroll
    for (int q = 0; q < kTile; ++q)
      st.alpha[q] = st.mine && st.j0 + q < n2 ? __ldg(a.alpha + st.j0 + q) : T(0);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const bool in = st.mine && in_tile(r, q);
        st.phi[r][q] = in ? __ldg(a.phi + at_e(r, q)) : T(0);
        st.g[r][q] = in ? __ldg(a.g + at_e(r, q)) : T(0);
        st.lam[r][q] = T(0);
      }
    if (st.mine) {
      load_lam(a.lam0);
      store_plane(a, st, plk);
    }
  } else {
    for (int kk = 0; kk < K && circuit(kk) < a.C; ++kk) {
      const size_t o = (size_t)circuit(kk) * S * n2;
      for (int e = tid; e < S * n2; e += nt) a.lam[o + e] = a.lam0[o + e];
    }
  }

  if (!stop) {
    // count mode: group g runs its first counts[g] iterations; no block
    // waits for another
    __syncthreads();
    for (int it = 0; it < a.max_iter; ++it) {
      int any = 0;
      for (int kk = tid; kk < K; kk += nt) {
        live[kk] = circuit(kk) < a.C && it < a.counts[circuit(kk) / a.P];
        any |= live[kk];
      }
      if (!__syncthreads_or(any)) break;
      Bits* dst = a.norms ? a.norms + (size_t)it * a.G : nullptr;
      if constexpr (kWShared) {
        resident_iteration<T>(a, it, st.mine && live[k], st, Ws + k * wsize, plk, red, live, dst);
      } else {
        for (int kk = 0; kk < K; ++kk) {
          if (!live[kk]) continue;
          const Bits mx = walk_circuit<T>(a, circuit(kk), w_of(circuit(kk)), plT, red);
          if (tid == 0 && dst) atomicMax(dst + circuit(kk) / a.P, mx);
        }
        __syncthreads();
      }
    }
    if (st.mine) store_lam();
    return;
  }

  // stop mode: slots [kRing][kChunk][G], -1 where a group did not run
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    for (int e = tid; e < a.G; e += nt) a.iters[e] = 0;
    if (tid == 0) *a.iters_max = 0;
  }
  for (int e = blockIdx.x * nt + tid; e < kRing * kChunk * a.G; e += gridDim.x * nt)
    a.slots[e] = -1;
  for (int kk = tid; kk < K; kk += nt) live[kk] = circuit(kk) < a.C && a.max_iter > 0;
  grid.sync();
  for (int base = 0, m = 0; base < a.max_iter; base += chunk, ++m) {
    const int len = min(chunk, a.max_iter - base);
    Bits* ring = a.slots + (size_t)(m % kRing) * kChunk * a.G;
    if (blockIdx.x == 0) {  // the ring two chunks ahead: read two barriers ago
      Bits* ahead = a.slots + (size_t)((m + 1) % kRing) * kChunk * a.G;
      for (int e = tid; e < kChunk * a.G; e += nt) ahead[e] = -1;
    }
    if constexpr (kWShared) {
      const bool run = st.mine && live[k];
      if (run && len > 1) store_lam();  // the chunk's start, for a replay
      for (int j = 0; j < len; ++j)
        resident_iteration<T>(a, base + j, run, st, Ws + k * wsize, plk, red, live,
                              ring + (size_t)j * a.G);
    } else {
      for (int kk = 0; kk < K; ++kk) {
        if (!live[kk]) continue;
        const Bits mx = walk_circuit<T>(a, circuit(kk), w_of(circuit(kk)), plT, red);
        if (tid == 0) atomicMax(ring + circuit(kk) / a.P, mx);
      }
    }
    grid.sync();
    // each group's first iteration of the chunk whose max |delta| is below
    // atol or NaN (-1: none; -2: the group did not run); every block
    // decides alike
    auto first_stop = [&](int grp) {
      Bits v[kChunk];  // every load in flight at once
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = j < len ? load_fresh(ring + (size_t)j * a.G + grp) : 0;
      if (v[0] < 0) return -2;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < len && !(N::value(v[j]) >= a.atol)) return j;
      return -1;
    };
    const bool last = base + len >= a.max_iter;
    int any = 0;
    for (int grp = tid; grp < a.G; grp += nt) {
      const int f = first_stop(grp);
      if (f == -1 && !last) any = 1;
      if (blockIdx.x == 0 && f != -2 && (f >= 0 || last)) {
        a.iters[grp] = base + (f >= 0 ? f + 1 : len);
        atomicMax(a.iters_max, base + (f >= 0 ? f + 1 : len));
      }
    }
    if (tid == 0) *replay = 0;
    __syncthreads();
    for (int kk = tid; kk < K; kk += nt) {
      stopj[kk] = live[kk] ? first_stop(circuit(kk) / a.P) : -2;
      if (stopj[kk] >= 0 && stopj[kk] < len - 1) atomicMax(replay, stopj[kk] + 1);
    }
    any = __syncthreads_or(any);
    if constexpr (kWShared) {
      // replay to the stop where a group stopped before the chunk's end
      const int n = *replay;
      if (n > 0) {
        const bool back = st.mine && stopj[k] >= 0 && stopj[k] < len - 1;
        if (back) {
          load_lam(a.lam);
          store_plane(a, st, plk + (base & 1) * psize);
        }
        __syncthreads();
        for (int j = 0; j < n; ++j)
          resident_iteration<T>(a, base + j, back && j <= stopj[k], st, Ws + k * wsize, plk, red,
                                live, nullptr);
      }
    }
    for (int kk = tid; kk < K; kk += nt) live[kk] = live[kk] && stopj[kk] == -1;
    __syncthreads();
    if (!any) break;
  }
  if (st.mine) store_lam();
}

template <typename T>
int tiles_of(int S, int n2) {
  return ((S + kTile - 1) / kTile) * ((n2 + kTile - 1) / kTile);
}

template <typename T>
size_t smem_bytes(int S, int n2, int K, bool resident) {
  const size_t Sp = (S + kTile - 1) / kTile * kTile, ld = (n2 + kTile - 1) / kTile * kTile;
  using Bits = typename Num<T>::Bits;
  const size_t ints = sizeof(int) * (2 * (size_t)K + 1);
  const size_t plane = n2 * Sp;
  if (resident) return sizeof(T) * (size_t)K * (n2 * ld + 2 * plane) + sizeof(Bits) * 2 * K + ints;
  return sizeof(T) * plane + sizeof(Bits) * 32 + ints;
}

struct Plan {
  int w_shared, K, grid, threads, blocks_per_sm;
  size_t smem;
};

template <typename T, bool kWShared>
cudaError_t occupancy(int threads, size_t smem, int* blocks) {
  auto kern = ift_adjoint_kernel<T, kWShared>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
}

// The resident path at the least K (circuits a block holds) whose K tiles'
// threads fit a block and whose grid of ceil(C / K) blocks is co-resident;
// else the device-memory path, the grid as many blocks as are co-resident
// (at most C), each walking ceil(C / grid) circuits.
template <typename T>
cudaError_t plan(int C, int S, int n2, Plan* p) {
  if (C < 1 || S < 1 || n2 < 1) return cudaErrorInvalidValue;
  const int tiles = tiles_of<T>(S, n2), most = max_threads<T>();
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto fits = [&](int K) {
    return K * tiles <= most && smem_bytes<T>(S, n2, K, true) <= (size_t)kMaxSmem;
  };
  if (fits(1)) {
    // blocks per SM only fall as K grows: start at the least K that one
    // circuit a block allows
    int nb1 = 0;
    if ((err = occupancy<T, true>((tiles + 31) / 32 * 32, smem_bytes<T>(S, n2, 1, true),
                                  &nb1)) != cudaSuccess)
      return err;
    for (int K = nb1 > 0 ? std::max(1, (C + nb1 * sms - 1) / (nb1 * sms)) : 1; fits(K); ++K) {
      const int threads = (K * tiles + 31) / 32 * 32;
      const size_t smem = smem_bytes<T>(S, n2, K, true);
      int nb = 0;
      if ((err = occupancy<T, true>(threads, smem, &nb)) != cudaSuccess) return err;
      const int grid = (C + K - 1) / K;
      if (nb > 0 && grid <= nb * sms) {
        *p = Plan{1, K, grid, threads, nb, smem};
        return cudaSuccess;
      }
    }
  }
  // K <= ceil(C / min(C, sms)) wherever one block fits an SM
  const int threads = std::min(most, (tiles + 31) / 32 * 32);
  const int K_most = (C + std::min(C, sms) - 1) / std::min(C, sms);
  const size_t smem = smem_bytes<T>(S, n2, K_most, false);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int nb = 0;
  if ((err = occupancy<T, false>(threads, smem, &nb)) != cudaSuccess) return err;
  if (nb < 1) return cudaErrorInvalidValue;
  const int grid = std::min(C, nb * sms);
  *p = Plan{0, (C + grid - 1) / grid, grid, threads, nb, smem};
  return cudaSuccess;
}

template <typename T>
int launch(const void* W, const void* w_index, const void* phi, const void* g, const void* alpha,
           const void* lam0, void* lam, int C, int G, int S, int n2, int max_iter, double atol,
           void* slots, void* iters, void* iters_max, const void* counts, void* norms,
           void* stream) {
  if (G < 1 || C % G != 0 || max_iter < 0) return (int)cudaErrorInvalidValue;
  if (!counts && (!slots || !iters || !iters_max)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan<T>(C, S, n2, &p);
  if (err != cudaSuccess) return (int)err;
  using Bits = typename Num<T>::Bits;
  Args<T> a;
  a.W = static_cast<const T*>(W);
  a.w_index = static_cast<const int*>(w_index);
  a.phi = static_cast<const T*>(phi);
  a.g = static_cast<const T*>(g);
  a.alpha = static_cast<const T*>(alpha);
  a.lam0 = static_cast<const T*>(lam0);
  a.lam = static_cast<T*>(lam);
  a.C = C, a.P = C / G, a.G = G, a.S = S, a.n2 = n2;
  a.Sp = (S + kTile - 1) / kTile * kTile, a.ld = (n2 + kTile - 1) / kTile * kTile, a.K = p.K;
  a.max_iter = max_iter;
  a.atol = (T)atol;
  a.slots = static_cast<Bits*>(slots);
  a.iters = static_cast<int*>(iters);
  a.iters_max = static_cast<int*>(iters_max);
  a.counts = static_cast<const int*>(counts);
  a.norms = static_cast<Bits*>(norms);
  void* args[] = {&a};
  const void* kern = p.w_shared ? (const void*)ift_adjoint_kernel<T, true>
                                : (const void*)ift_adjoint_kernel<T, false>;
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(p.threads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" {

// Stop-test slots a group needs in the scratch of a stop-mode launch.
int ift_adjoint_slots_per_group() { return kRing * kChunk; }

// Runs the adjoint iteration of C circuits in G groups on `stream`, one
// cooperative launch. dtype 0: float, 1: double (every array in it; W's
// index and the integer outputs int32). Stop mode where `counts` is null:
// the device's stop test at `atol` within `max_iter` iterations, `slots`
// scratch of ift_adjoint_slots_per_group() G bits (int32 for float, int64
// for double), `iters` (G,) and `iters_max` (1,) written. Count mode: group k runs counts[k] <=
// max_iter iterations; `norms` null or (max_iter, G), zeroed, receiving
// each iteration's max |delta| per group. Returns the cudaError_t of the
// attribute, occupancy or launch call, 0 on success; cudaErrorInvalidValue
// for arguments the kernel does not take.
int ift_adjoint_launch(int dtype, const void* W, const void* w_index, const void* phi,
                       const void* g, const void* alpha, const void* lam0, void* lam, int C,
                       int G, int S, int n2, int max_iter, double atol, void* slots, void* iters,
                       void* iters_max, const void* counts, void* norms, void* stream) {
  if (dtype == 0)
    return launch<float>(W, w_index, phi, g, alpha, lam0, lam, C, G, S, n2, max_iter, atol,
                         slots, iters, iters_max, counts, norms, stream);
  if (dtype == 1)
    return launch<double>(W, w_index, phi, g, alpha, lam0, lam, C, G, S, n2, max_iter, atol,
                          slots, iters, iters_max, counts, norms, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch's plan on the current device: out = {W in shared memory,
// circuits a block holds, grid, threads, blocks per SM, shared bytes}.
int ift_adjoint_query(int dtype, int C, int S, int n2, int* out) {
  Plan p;
  cudaError_t err = dtype == 0   ? plan<float>(C, S, n2, &p)
                    : dtype == 1 ? plan<double>(C, S, n2, &p)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = p.w_shared, out[1] = p.K, out[2] = p.grid, out[3] = p.threads;
  out[4] = p.blocks_per_sm, out[5] = (int)p.smem;
  return 0;
}

const char* ift_adjoint_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
