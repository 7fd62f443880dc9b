// Fused SSN fixed-point solver for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel tcgan_tpu/ops/pallas/ssn_solve.py::
// _solver_kernel (launched by solve_fixed_point_pallas through
// pl.pallas_call). It computes what that kernel computes, per circuit b and
// stimulus row s:
//
//   r <- min(r + active * alpha (-r + f(W_b r + I_s)), 10 * rate_stop_at)
//
// check_every substeps per chunk; at the end of each chunk a row converges
// when max_i |delta_i| < atol of its last substep, diverges when
// max_i r_i > rate_stop_at, and records iters = min(it, max_iter) when it
// resolves. Resolved rows are frozen. Optional Anderson(1) on the chunk
// map, with the same safeguards as the lockstep solver
// (tcgan_torch/ops/fixed_point.py).
//
// Design. One thread block per circuit loops until all S rows of that
// circuit resolve or max_iter is reached (per-circuit early exit). W stays
// resident in shared memory, transposed (Wt[j * n2 + i] = W[i, j]), for the
// whole solve, so each substep reads W from shared memory and never from
// HBM. Thread i owns neuron i of every row: it accumulates u[s, i] for
// kRowChunk rows at once, so one shared load of W[i, j] feeds kRowChunk
// FMAs, and the rates are read as broadcast float4 (rows padded to ld, a
// multiple of 4, with zeros). The rates are double-buffered, so a substep
// costs one __syncthreads. Every substep runs in fp32 on CUDA cores; the
// io function uses exact expf/logf/tanhf (build without --use_fast_math:
// the flags at the atol crossing depend on them).
//
// What bounds it: a small latency- and sync-bound mat-vec per substep
// (2N x 2N by S rows, ~83k FMAs at N=51, S=8), read from shared memory;
// HBM traffic is O(W) per solve instead of O(iters * W).
//
// Shared-memory layout (floats, then ints), mirrored by
// tcgan_torch/ops/cuda/ssn_solve.py::smem_bytes:
//   Wt   ld * n2        transposed weights, rows j >= n2 zero
//   Is   rows * ld      stimulus battery
//   rA   rows * ld      rates, double buffer
//   rB   rows * ld
//   dab  rows * ld      |delta| of the chunk's last substep
//   [accel] rst, rip, fpv  rows * ld each: chunk input, previous chunk
//                          input, previous chunk displacement
//   flag S ints (0 active, 1 converged, 2 diverged), iters S ints,
//   n_active 1 int
// with ld = round_up(n2, 4) and rows = round_up(S, kRowChunk).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowChunk = 8;

struct Params {
  int n2, S, ld, rows;
  int io_type;  // 0 asym_power, 1 asym_tanh, 2 asym_linear
  float k, n, r0, r1, u0, slope;
  float atol, rate_stop_at, ceiling;
  int max_iter, check_every, init_ff, accel;
};

__host__ __device__ inline int round_up(int x, int m) {
  return ((x + m - 1) / m) * m;
}

__device__ __forceinline__ float power_io(float u, const Params& p) {
  // exp/log form with the log(0) guard of the TPU kernel's _io_fns
  float up = fmaxf(u, 0.0f);
  float fp = expf(p.n * logf(fmaxf(up, 1e-30f))) * p.k;
  return up > 0.0f ? fp : 0.0f;
}

__device__ __forceinline__ float io_fun(float u, const Params& p) {
  float fp = power_io(u, p);
  if (p.io_type == 1) {
    float d = p.r1 - p.r0;
    float arg = fminf(fmaxf(fmaxf(fp - p.r0, 0.0f) / d, 0.0f), 30.0f);
    return fp <= p.r0 ? fp : p.r0 + d * tanhf(arg);
  }
  if (p.io_type == 2) {
    return u <= p.u0 ? fp : p.r0 + p.slope * (u - p.u0);
  }
  return fp;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ssn_solve_kernel(const float* __restrict__ W,
                                 const float* __restrict__ I,
                                 const float* __restrict__ alpha,
                                 float* __restrict__ r_out,
                                 uint8_t* __restrict__ conv_out,
                                 uint8_t* __restrict__ div_out,
                                 int* __restrict__ iters_out, Params p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n2 = p.n2, S = p.S, ld = p.ld, rows = p.rows;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int b = blockIdx.x;
  const size_t plane = (size_t)rows * ld;

  float* Wt = smem;
  float* Is = Wt + (size_t)ld * n2;
  float* cur = Is + plane;
  float* nxt = cur + plane;
  float* dab = nxt + plane;
  float* rst = dab + plane;  // the three Anderson planes exist only if accel
  float* rip = rst + plane;
  float* fpv = rip + plane;
  int* flag = reinterpret_cast<int*>(p.accel ? fpv + plane : rst);
  int* iters = flag + S;
  int* n_active = iters + S;

  const size_t n_floats = (size_t)ld * n2 + plane * (p.accel ? 7 : 4);
  for (size_t e = tid; e < n_floats; e += nthreads) smem[e] = 0.0f;
  __syncthreads();

  const float* Wb = W + (size_t)b * n2 * n2;
  for (int e = tid; e < n2 * n2; e += nthreads) {
    int i = e / n2, j = e - i * n2;
    Wt[j * n2 + i] = Wb[e];
  }
  for (int e = tid; e < S * n2; e += nthreads) {
    int s = e / n2, i = e - s * n2;
    float x = I[e];
    Is[s * ld + i] = x;
    cur[s * ld + i] = p.init_ff ? io_fun(x, p) : 0.0f;
  }
  for (int s = tid; s < S; s += nthreads) {
    flag[s] = 0;
    iters[s] = p.max_iter;
  }
  if (tid == 0) *n_active = S;
  const float a_i = tid < n2 ? alpha[tid] : 0.0f;
  __syncthreads();

  int it = 0;
  int nhist = 0;
  while (it < p.max_iter && *n_active > 0) {
    for (int sub = 0; sub < p.check_every; ++sub) {
      const bool last = sub == p.check_every - 1;
      if (tid < n2) {
        for (int s0 = 0; s0 < rows; s0 += kRowChunk) {
          bool any = false;
          for (int c = 0; c < kRowChunk && s0 + c < S; ++c) any |= flag[s0 + c] == 0;
          if (!any) {
            for (int c = 0; c < kRowChunk && s0 + c < S; ++c)
              nxt[(s0 + c) * ld + tid] = cur[(s0 + c) * ld + tid];
            continue;
          }
          float acc[kRowChunk];
#pragma unroll
          for (int c = 0; c < kRowChunk; ++c) acc[c] = 0.0f;
          for (int j = 0; j < ld; j += 4) {
            const float w0 = Wt[(j + 0) * n2 + tid];
            const float w1 = Wt[(j + 1) * n2 + tid];
            const float w2 = Wt[(j + 2) * n2 + tid];
            const float w3 = Wt[(j + 3) * n2 + tid];
#pragma unroll
            for (int c = 0; c < kRowChunk; ++c) {
              const float4 rv = *reinterpret_cast<const float4*>(cur + (s0 + c) * ld + j);
              acc[c] = fmaf(w0, rv.x, acc[c]);
              acc[c] = fmaf(w1, rv.y, acc[c]);
              acc[c] = fmaf(w2, rv.z, acc[c]);
              acc[c] = fmaf(w3, rv.w, acc[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < kRowChunk; ++c) {
            const int s = s0 + c;
            if (s >= S) break;
            const int e = s * ld + tid;
            const float r = cur[e];
            if (flag[s] != 0) {
              nxt[e] = r;
              continue;
            }
            if (p.accel && sub == 0) rst[e] = r;
            const float d = io_fun(acc[c] + Is[e], p) - r;
            nxt[e] = fminf(__fadd_rn(r, __fmul_rn(a_i, d)), p.ceiling);
            if (last) dab[e] = fabsf(d);
          }
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }

    // Chunk epilogue: one warp per row.
    const int it_next = it + p.check_every;
    for (int s = warp; s < S; s += nwarps) {
      if (flag[s] != 0) continue;
      float* rc = cur + s * ld;
      float err = 0.0f, peak = -INFINITY;
      for (int i = lane; i < n2; i += 32) {
        err = fmaxf(err, dab[s * ld + i]);
        peak = fmaxf(peak, rc[i]);
      }
      err = warp_max(err);
      peak = warp_max(peak);
      const bool newly_div = peak > p.rate_stop_at;
      const bool newly_conv = !newly_div && err < p.atol;
      const bool resolved = newly_div || newly_conv;
      if (p.accel) {
        float* r_in = rst + s * ld;
        float* r_in_prev = rip + s * ld;
        float* f_prev = fpv + s * ld;
        float num = 0.0f, den = 0.0f;
        for (int i = lane; i < n2; i += 32) {
          const float fc = rc[i] - r_in[i];
          const float dF = fc - f_prev[i];
          den += dF * dF;
          num += fc * dF;
        }
        den = warp_sum(den);
        num = warp_sum(num);
        const float gamma = num / (den + 1e-30f);
        float peak_aa = -INFINITY;
        for (int i = lane; i < n2; i += 32) {
          const float h_prev = r_in_prev[i] + f_prev[i];
          const float raa = fminf(fmaxf(rc[i] - gamma * (rc[i] - h_prev), 0.0f), p.ceiling);
          peak_aa = fmaxf(peak_aa, raa);
        }
        peak_aa = warp_max(peak_aa);
        const bool ok = nhist > 0 && fabsf(gamma) < 2.0f && den > 0.0f &&
                        peak_aa <= p.rate_stop_at && !resolved;
        for (int i = lane; i < n2; i += 32) {
          const float fc = rc[i] - r_in[i];
          const float h_prev = r_in_prev[i] + f_prev[i];
          if (ok) rc[i] = fminf(fmaxf(rc[i] - gamma * (rc[i] - h_prev), 0.0f), p.ceiling);
          r_in_prev[i] = r_in[i];
          f_prev[i] = fc;
        }
      }
      if (lane == 0 && resolved) {
        flag[s] = newly_div ? 2 : 1;
        // the last chunk may overshoot max_iter by up to check_every - 1
        // substeps; iters == max_iter keeps meaning "unresolved"
        iters[s] = min(it_next, p.max_iter);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int s = 0; s < S; ++s) n += flag[s] == 0;
      *n_active = n;
    }
    it = it_next;
    ++nhist;
    __syncthreads();
  }

  float* rb = r_out + (size_t)b * S * n2;
  for (int e = tid; e < S * n2; e += nthreads) {
    int s = e / n2, i = e - s * n2;
    rb[e] = cur[s * ld + i];
  }
  for (int s = tid; s < S; s += nthreads) {
    conv_out[(size_t)b * S + s] = flag[s] == 1;
    div_out[(size_t)b * S + s] = flag[s] == 2;
    iters_out[(size_t)b * S + s] = iters[s];
  }
}

size_t smem_bytes(int n2, int S, int accel) {
  const size_t ld = round_up(n2, 4), rows = round_up(S, kRowChunk);
  const size_t floats = ld * n2 + rows * ld * (accel ? 7 : 4);
  return floats * sizeof(float) + (2 * (size_t)S + 1) * sizeof(int);
}

// One thread per neuron, whole warps.
int block_threads(int n2) { return round_up(n2 > 32 ? n2 : 32, 32); }

}  // namespace

extern "C" {

// Launches the solve of B circuits on `stream`; returns the cudaError_t of
// the attribute call or of the launch (cudaGetLastError), 0 on success.
int ssn_solve_launch(const void* W, const void* I, const void* alpha, void* r,
                     void* conv, void* div, void* iters, int B, int n2, int S,
                     int io_type, float k, float n, float r0, float r1,
                     float u0, float slope, float atol, float rate_stop_at,
                     float ceiling, int max_iter, int check_every, int init_ff,
                     int accel, void* stream) {
  Params p;
  p.n2 = n2;
  p.S = S;
  p.ld = round_up(n2, 4);
  p.rows = round_up(S, kRowChunk);
  p.io_type = io_type;
  p.k = k;
  p.n = n;
  p.r0 = r0;
  p.r1 = r1;
  p.u0 = u0;
  p.slope = slope;
  p.atol = atol;
  p.rate_stop_at = rate_stop_at;
  p.ceiling = ceiling;
  p.max_iter = max_iter;
  p.check_every = check_every;
  p.init_ff = init_ff;
  p.accel = accel;
  const size_t bytes = smem_bytes(n2, S, accel);
  cudaError_t err = cudaFuncSetAttribute(
      ssn_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = block_threads(n2);
  ssn_solve_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(I),
      static_cast<const float*>(alpha), static_cast<float*>(r),
      static_cast<uint8_t*>(conv), static_cast<uint8_t*>(div),
      static_cast<int*>(iters), p);
  return (int)cudaGetLastError();
}

// Blocks of the compiled kernel that one SM of the current device holds at
// this shape (the runtime's occupancy calculation: registers, threads and
// dynamic shared memory); minus the cudaError_t on failure.
int ssn_solve_blocks_per_sm(int n2, int S, int accel) {
  const size_t bytes = smem_bytes(n2, S, accel);
  cudaError_t err = cudaFuncSetAttribute(
      ssn_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssn_solve_kernel, block_threads(n2), bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* ssn_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
