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
// What bounds it. The work is 2 (2N)^2 FLOP per row and substep, summed
// over the substeps each row needs (4.05e10 FLOP at N=51, S=8, B=512 with
// mean 475 iterations). The kernel runs it as 3 TF32 products (3xTF32,
// below), 1.2e11 FLOP: 0.245 ms at the 495 TFLOP/s dense TF32 peak of the
// tensor cores, the bound chip_smoke.py reports (the 4.05e10 FLOP at the 67
// TFLOP/s fp32 peak outside them would take 0.60 ms). Device-memory
// traffic is O(W + r) per solve (~23 MB there, ~7 us), so the bound is the
// arithmetic. A block runs until its slowest row resolves (1,100-1,800
// substeps against a mean of 475), so the launch time is the slowest
// circuit's substep latency times its substeps: at small B, where most SMs
// idle, that latency is all there is; at B=512 two blocks share an SM and
// the batch runs in two waves.
//
// Design. One thread block per circuit loops until all S rows of that
// circuit resolve or max_iter is reached. Per substep the block computes
// U = W R^T (neurons x rows) on the tensor cores with warp-level
// mma.sync.m16n8k8 TF32 (not wgmma: the tiles are tiny and each substep is
// a short dependent chain): each warp owns one m16 slab of neurons (2N=102:
// 7 warps) and every n8 tile of rows, so no sum crosses a warp. The io
// function (on the fragment's four elements at once, so that their exp/log
// chains overlap), the step gain, the ceiling clamp and the chunk's |delta|
// are computed on the accumulator fragments; the new rates go to the other
// rate buffer, one __syncthreads per substep. An n8 tile whose rows have all
// resolved is skipped. W is loaded once per solve. Up to 2N=112 (N=51
// included) the high TF32 parts of each thread's W fragments stay in
// registers (56) and shared memory holds the low parts, so a k-step costs
// four shared loads for W and no arithmetic; two blocks fit an SM (128
// registers). Past 2N=112 the high parts would not fit beside the rest (4
// registers per k-step, 112 at 2N=224), so shared memory holds W in fp32
// and each fragment is split as it is loaded; storing hi and lo planes
// would halve the largest N.
//
// Where the time goes: a substep is a chain of 13-14 dependent k-steps of
// three mma.sync each per n8 tile, then the io function's exact exp/log on
// the fragments, then the barrier; the slowest circuit's substep takes
// 1.8-3.3 us on an H100 at 700 W against 3.9-5.9 us for the fp32
// CUDA-core kernel this design replaced (PERF.md), far from the
// bound: the mma chain's latency and issue rate, not its FLOP, set it.
// Past the register path a warp's chain is 2N/8 k-steps long (51 at the
// paper's 2N=402), and on clusters of 8 a block has 4 warps, one an SM
// scheduler, so nothing hides that latency. Where the plan gives a cluster
// such blocks of at most 4 warps (their layout holds W, so one block an SM)
// or reads W from device memory, the refinement-tail kernels therefore run
// the one-pass loop (phase 1 and the tail's corrections, ~97% of the
// substeps) as kPartials independent partial sums per n8 tile, operands
// loaded a turn ahead (mma_partials_1x, kPartialSums): at the N=201 fit's
// shape (2N=402, S=16, clusters of 8) its substep costs 0.66-0.68 of the
// single chain's, at 2N=600 S=8 (W from device memory) 0.69-0.72.
// Elsewhere other warps hide the single chain: at 2N=402 S=8 on clusters
// of 4 (7 warps an SM) the partial sums cost 0.99 of it, at 2N=240 S=8 on
// clusters of 2 (8 warps) 1.05-1.12, so the plan keeps the single chain
// (PERF.md, H100 at 700 W). The 3xTF32 loop keeps three chains, hh, hl and lh.
//
// Precision: 3xTF32. Each operand x is split into x_hi = rna_tf32(x) and
// x_lo = rna_tf32(x - x_hi); hi*hi, hi*lo and lo*hi go to three fp32
// accumulators (three independent mma chains), summed as hh + (hl + lh) at
// the end. One TF32 pass is not enough: at N=51, 16 circuits, the 16-row
// GAN battery and atol 1e-5, the lockstep solver with that rounding
// changes 38 flags and leaves 14.8% of the rows unconverged (iterations off
// by up to 9,520), where 3xTF32 changes none (max |dr| 7.4e-6, iterations
// within one check stride; tests/test_torch_ssn_solve_tf32.py replays both
// on the CPU). On the card the kernel gives the fp32 lockstep solver's
// flags at every shape tested. The io function uses exact expf/logf/tanhf
// (build without --use_fast_math: the flags at the atol crossing depend on
// them).
//
// Shared-memory layout (floats, then ints), mirrored by
// tcgan_torch/ops/cuda/ssn_solve.py::smem_bytes:
//   Ws   n2 * ld       weights, row-major (Ws[i * ld + j] = W[i, j]); in a
//                      cluster, the block's min(m, n2) rows; none on the
//                      W-global path (below)
//   Is   rows * ld     stimulus battery (in a cluster, this and the Anderson
//                      planes hold the block's slab at stride lds)
//   rA   rows * ld     rates, double buffer
//   rB   rows * ld
//   [accel] rst, rip, fpv  rows * ld each: chunk input, previous chunk
//                          input, previous chunk displacement
//   [refine] ua, [no accel] rb  rows * ld each: the refinement tail's
//                          anchor and the chunk's input rates (rst with accel)
//   flag R ints (0 active, 1 converged, 2 diverged), iters R ints,
//   err rows ints (max |delta| of the chunk's last substep, as float bits),
//   live rows / 8 ints (active rows per n8 tile), n_active 1 int
// with R the rows a block solves (S, or a chunk of them: below), rows =
// round_up(R, 8) and ld the least stride >= n2 that is 4 mod 8,
// so the fragment loads and the rate stores hit 32 distinct banks
// (round_up(n2, 4) where that padding would not fit).
//
// Circuits beyond one block (the paper's N=201: W alone is 646 KB in fp32,
// about three times a block's shared memory). A thread-block cluster of c
// blocks (c in 2, 4, 8, the least whose layout fits) solves one circuit.
// Block `rank` owns the slab of m = round_up(ceil(2N / c), 16) neurons from
// rank * m: its rows of W, one warp per m16 slab of them as above. Both rate
// planes hold all 2N neurons in every block; Is and the three Anderson
// planes hold the block's slab alone (stride lds, the same bank rule on m).
// Each substep a block computes its slab of W r + I, the io function and the
// step, and stores its new rates into the next rate plane of every block of
// the cluster through distributed shared memory; one cluster barrier
// (arrive.release / wait.acquire) per substep takes the place of
// __syncthreads. The chunk's max |delta| goes into every block by remote
// atomicMax, so every block reaches the same flags from its own copy of the
// rates; Anderson's per-row sums are exchanged per rank and added in rank
// order, so every block computes bit-identical gamma, flags, iters and
// n_active and runs the same number of barriers (a block that disagreed
// would deadlock the cluster). After the ints come, for Anderson, per rank
// and row: the partial num, den and peak of the extrapolated point. The
// work per substep is the same as in one block, spread over c SMs; a
// substep adds c remote stores per rate and the cluster barrier's latency.
// c = 1 is the single-block kernel, with the cluster code compiled out.
//
// Batteries past a cluster of 8 (both rate planes of every row sit whole in
// every block, so the largest 2N falls as S grows). A circuit's rows are
// independent: each has its own residual, peak, flags, iters, frozen update
// and Anderson sums, and the chunk count that gates Anderson is the same for
// every row. So the launch plan (plan(), mirrored by
// tcgan_torch/ops/cuda/ssn_solve.py::plan) splits the S rows into K chunks
// of R rows, each solved by its own block or cluster against the circuit's
// whole W, which computes what one launch over all S rows computes. Where a
// cluster of 1, 2, 4 or 8 fits the whole battery the plan is R = S, K = 1
// and the launch is the one above. Otherwise it takes the least c at which
// an 8-row chunk fits, the most rows (a multiple of 8) that fit there, K =
// ceil(S / that), and R = round_up(ceil(S / K), 8) to balance the chunks.
// The grid holds B * K clusters of c blocks, circuit-major; each chunk reads
// W from device memory once more.
//
// Circuits whose W slab leaves no room for 8 rows in a cluster of 8 (2N >=
// 598, 578 with Anderson: at 2N=600 the slab alone is 193 KB of the 227).
// The W-global path (kWGlobal, a cluster instantiation) keeps no W in shared
// memory: each warp reads its 16 rows of the circuit's W from device memory
// in the k-loop, every substep (through L1 and L2; at 2N=600 and B=64 the
// resident circuits' W is 92 MB, past the 50 MB L2), in the same order, split
// into TF32 parts the same way, so a launch is bit-equal to the shared-W
// launch at the same cluster size and rows. Everything else is the cluster
// path as above. The plan takes it only where no shared-W plan exists: the
// least c in 2, 4, 8 whose slab needs at most 16 warps and whose layout
// without W holds the battery, else the least such c that holds 8 rows and
// the row chunks above. A block of a cluster of 8 holds at most 512 threads,
// 16 warps of 16 neurons, so 2N <= 2048; wider circuits are refused.
//
// The two-phase schedule (kTwoPhase, every path; the TPU kernel's default,
// _solver_kernel :291-343). Phase 1 runs each k-step as one TF32 product
// (W and r rounded to TF32, one mma.sync into hh: the tensor cores' single
// pass, in the role of the TPU's fast default-precision pass) down to a
// coarse residual max(100 atol, 1e-2), within max_iter / 2 substeps; a row
// resolved there is frozen, as in one phase. It ends at the first chunk
// boundary where every row of the block's chunk has resolved or the budget
// is spent. (One TF32 pass over a whole solve breaks flags, above; phase 2
// decides every flag again in 3xTF32, which holds them:
// tests/test_torch_ssn_solve_tf32.py replays both on the CPU.) At the
// boundary every row's converged flag is cleared, and so is every
// diverged flag but those of rows whose peak rate lies above reopen_at
// (margin * rate_stop_at, when the margin is above 0: hard divergers keep
// their flag and phase-1 iters); reopened rows get iters = max_iter back,
// Anderson's history restarts, and phase 2, the 3xTF32 loop above, runs on
// from the same substep count to atol and max_iter. The TPU kernel puts the
// boundary on a tile of block_b circuits; here it is the unit of launch, one
// circuit's chunk of rows (a block or a cluster), which is the TPU kernel at
// block_b = 1 wherever the battery is one chunk. In a cluster every block
// takes the switch from its own flags and its own copy of the rate planes,
// which are bit-identical across the cluster, so all take it at the same
// chunk.
//
// The refinement tail (kRefine, with kTwoPhase; the TPU kernel's default
// phase 2, _solver_kernel :252-273). Phase 2 iterates on the correction e =
// r - r_base from the chunk's input rates r_base: substep 0 of each chunk
// runs the 3xTF32 k-loop on the rate plane, which holds r_base, and keeps its
// u = W r_base + I (the anchor) and r_base for the block's own neurons in two
// slab planes (r_base in Anderson's chunk-input plane where it has one);
// substeps 1 .. check_every - 1 run the one-TF32-pass k-loop of phase 1 on e,
// which the rate planes then hold (in a cluster it is what travels through
// distributed shared memory), with u = anchor + W e. The step is delta =
// f(u) - (r_base + e), e <- min(e + alpha delta, ceiling - r_base), and the
// chunk's last substep stores r_base + e, so that every block's rate plane
// holds the whole r for the epilogue, Anderson and the next anchor. The
// rounding error of one TF32 pass is relative to |e|, not |r|, so phase 2's
// mat-vec costs phase 1's while the result keeps fp32 accuracy
// (tests/test_torch_ssn_solve_tf32.py holds the flags on the CPU). Frozen
// rows keep r in both planes; the columns the k-loop computes for them are
// not stored. The anchor and r_base are written and read by the one thread
// that owns the element, so they need no barrier of their own. What it
// buys (PERF.md, H100 at 700 W, every substep run, atol 0): a tail substep
// costs 0.77-0.82 of a one-phase 3xTF32 substep at N=51 with two blocks an
// SM, 0.82-0.94 on clusters, 0.95 at 2N=600 (W's loads), but 0.91 with one
// block an SM (B=32: the chain's latency, not the mma issue, sets the
// substep) and 1.07 at 4 row tiles of the register path, where it spills.

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileM = 16, kTileN = 8, kTileK = 8;  // mma.m16n8k8
constexpr int kMaxGroupN = 4;  // n8 tiles a warp accumulates at once
constexpr int kMaxThreads = 512;
// Register path, 2N <= 8 * kRegK: the high TF32 parts of a warp's W
// fragments stay in registers (4 per k-step) and shared memory holds the low
// parts. Beyond, shared memory holds W in fp32 and each fragment is split as
// it is loaded.
constexpr int kRegK = 14;
constexpr size_t kMaxSmemBytes = 232448;  // a block's dynamic shared memory on Hopper
constexpr int kClusterSizes[] = {1, 2, 4, 8};  // 8: the portable maximum

struct Params {
  // S_all: the battery's rows; R: rows per chunk (S_all in one chunk);
  // chunks: chunks per circuit; rows, ntiles: R rounded up to n8 tiles
  int n2, S_all, R, chunks, ld, rows, ktiles, ntiles;
  int io_type;  // 0 asym_power, 1 asym_tanh, 2 asym_linear
  float k, n, r0, r1, u0, slope;
  float atol, rate_stop_at, ceiling;
  int max_iter, check_every, init_ff, accel;
  // cluster path: blocks per circuit, neurons per block (slab), the slab
  // planes' stride, and W's rows per block (min(slab, n2))
  int cluster, slab, lds, wrows;
  // two-phase schedule: phase 1's residual and substep budget; phase-1
  // diverged rows whose peak passes reopen_at keep their flag (reopen_at
  // <= 0: every row reopens)
  float coarse, reopen_at;
  int max_iter1;
  // null, or two totals the launch adds its row-substeps into, phase 1's
  // and phase 2's (one phase: all in phase 2)
  unsigned long long* substeps;
};

// Stores v at the same shared-memory offset as p in every block of the
// cluster (distributed shared memory).
__device__ __forceinline__ void store_all(cg::cluster_group& cl, float* p, float v, int c) {
  for (int q = 0; q < c; ++q) *cl.map_shared_rank(p, q) = v;
}

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

// Round to TF32 (10-bit mantissa), to nearest, ties away from zero: what
// cvt.rna.tf32.f32 computes for finite x, in two integer operations (the cvt
// lowers to four, with a check for inf and NaN that finite rates never
// need).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 21 bits: hi = rna_tf32(x), lo = rna_tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 inputs, fp32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of U += W R^T for NT n8 tiles of rows in 3xTF32: the A
// fragments (this warp's 16 neurons, 8 columns) come split; each B fragment
// (rows g of the tiles, columns t and t + 4 from rb) is split here.
// in4: column t + 4 lies inside 2N (else it reads as zero).
template <int NT>
__device__ __forceinline__ void mma_kstep(float (&hh)[NT][4], float (&hl)[NT][4],
                                          float (&lh)[NT][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const float* rb,
                                          int tile_stride, bool in4, const bool (&on)[NT]) {
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    if (!on[q]) continue;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(rb[q * tile_stride], bh0, bl0);
    split_tf32(in4 ? rb[q * tile_stride + 4] : 0.0f, bh1, bl1);
    mma_tf32(hh[q], ah, bh0, bh1);
    mma_tf32(hl[q], ah, bl0, bl1);
    mma_tf32(lh[q], al, bh0, bh1);
  }
}

// The same k-step in one TF32 pass (phase 1 of the two-phase schedule): the
// high parts alone, into hh.
template <int NT>
__device__ __forceinline__ void mma_kstep_1x(float (&hh)[NT][4], const uint32_t (&ah)[4],
                                             const float* rb, int tile_stride, bool in4,
                                             const bool (&on)[NT]) {
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    if (!on[q]) continue;
    mma_tf32(hh[q], ah, rna_tf32(rb[q * tile_stride]),
             rna_tf32(in4 ? rb[q * tile_stride + 4] : 0.0f));
  }
}

// The refinement-tail kernels' one-pass loop as partial sums (kPartialSums)
// keeps kPartials independent accumulators per n8 tile, one for each class
// of k-steps kt mod kPartials, so that each warp runs that many mma chains
// at once, not one chain of all 2N/8 k-steps: four up to two row tiles, two
// past them, where the operands in flight take the registers.
template <int NT>
constexpr int kPartials = NT <= 2 ? 4 : 2;

// The operands of one k-step in one TF32 pass: this thread's four W values
// and its two rates of each n8 tile, rounded to TF32.
template <int NT>
struct Kstep1x {
  uint32_t a[4];
  uint32_t b[NT][2];
};

// Loads k-step kt into o as the one-pass loop reads it (W from Ws or, on
// the W-global path, device memory, where column j + t may pass n2 and
// there is no zero padding); a k-step that is not live, and the rates of a
// tile that is off (it may lie past the rate plane), read nothing and hold
// zeros. (Pointing an off tile at the group's first instead, an address
// chosen once a group, ran 5-7% faster but made ptxas spill on the
// W-global path: PERF.md.)
template <int NT, bool kWGlobal, typename WPtr>
__device__ __forceinline__ void load_kstep_1x(Kstep1x<NT>& o, WPtr w0, WPtr w1, const float* rb,
                                              int tile_stride, int kt, bool live, int n2, int t,
                                              bool in0, bool in1, const bool (&on)[NT]) {
  const int j = kt * kTileK;
  const bool in4 = live && j + t + 4 < n2;
  const bool inj = live && (!kWGlobal || j + t < n2);
  o.a[0] = rna_tf32(in0 && inj ? w0[j] : 0.0f);
  o.a[1] = rna_tf32(in1 && inj ? w1[j] : 0.0f);
  o.a[2] = rna_tf32(in0 && in4 ? w0[j + 4] : 0.0f);
  o.a[3] = rna_tf32(in1 && in4 ? w1[j + 4] : 0.0f);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    o.b[q][0] = rna_tf32(live && on[q] ? rb[q * tile_stride + j] : 0.0f);
    o.b[q][1] = rna_tf32(in4 && on[q] ? rb[q * tile_stride + j + 4] : 0.0f);
  }
}

// One k-step's products into acc, for the n8 tiles that are on.
template <int NT>
__device__ __forceinline__ void mma_1x(float (&acc)[NT][4], const Kstep1x<NT>& o,
                                       const bool (&on)[NT]) {
#pragma unroll
  for (int q = 0; q < NT; ++q)
    if (on[q]) mma_tf32(acc[q], o.a, o.b[q][0], o.b[q][1]);
}

// U += W R^T in one TF32 pass into hh, as independent partial sums: k-step
// kt goes into partial kt mod kPartials, and the loop runs kPartials
// k-steps a turn, loading the next turn's operands before this turn's
// mma.sync are issued, so no load or rounding sits on an accumulator's
// chain. At the end the partials are added in one fixed order, ((p0 + p1) +
// (p2 + p3)) or (p0 + p1), into hh (zero on entry). The products are those
// of mma_kstep_1x. (Unrolling the turns by two, or folding the last turns
// into a loop, made ptxas spill at two row tiles and ran slower: PERF.md.)
template <int NT, bool kWGlobal, typename WPtr>
__device__ __forceinline__ void mma_partials_1x(float (&hh)[NT][4], WPtr w0, WPtr w1,
                                                const float* rb, int tile_stride, int ktiles,
                                                int n2, int t, bool in0, bool in1,
                                                const bool (&on)[NT]) {
  constexpr int P = kPartials<NT>;
  float acc[P][NT][4];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][q][c] = 0.0f;
  Kstep1x<NT> op[P];
#pragma unroll
  for (int k = 0; k < P; ++k)
    load_kstep_1x<NT, kWGlobal>(op[k], w0, w1, rb, tile_stride, k, k < ktiles, n2, t, in0, in1,
                                on);
  // whole turns whose next turn lies inside 2N as well: no bound to test
  int kt0 = 0;
  for (; kt0 + 2 * P <= ktiles; kt0 += P) {
    Kstep1x<NT> nx[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      load_kstep_1x<NT, kWGlobal>(nx[k], w0, w1, rb, tile_stride, kt0 + P + k, true, n2, t, in0,
                                  in1, on);
#pragma unroll
    for (int k = 0; k < P; ++k) mma_1x<NT>(acc[k], op[k], on);
#pragma unroll
    for (int k = 0; k < P; ++k) op[k] = nx[k];
  }
  // the last k-steps, kt0 .. ktiles - 1: fewer than two turns
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (kt0 + k < ktiles) mma_1x<NT>(acc[k], op[k], on);
    const int kt = kt0 + P + k;
    load_kstep_1x<NT, kWGlobal>(op[k], w0, w1, rb, tile_stride, kt, kt < ktiles, n2, t, in0, in1,
                                on);
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (kt0 + P + k < ktiles) mma_1x<NT>(acc[k], op[k], on);
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (P == 4)
        hh[q][c] = (acc[0][q][c] + acc[1][q][c]) + (acc[2][q][c] + acc[3][q][c]);
      else
        hh[q][c] = acc[0][q][c] + acc[1][q][c];
    }
}

// io_fun on four independent inputs in one straight line, so that their
// exp/log chains overlap.
__device__ __forceinline__ void io_fun4(const float (&u)[4], float (&f)[4], const Params& p) {
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = power_io(u[c], p);
  if (p.io_type == 1) {
    const float d = p.r1 - p.r0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float arg = fminf(fmaxf(fmaxf(f[c] - p.r0, 0.0f) / d, 0.0f), 30.0f);
      f[c] = f[c] <= p.r0 ? f[c] : p.r0 + d * tanhf(arg);
    }
  } else if (p.io_type == 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = u[c] <= p.u0 ? f[c] : p.r0 + p.slope * (u[c] - p.u0);
  }
}

// The two-phase schedule's boundary, on a block's S rows: clear every flag
// but those of diverged rows whose frozen peak passes reopen_at (both rate
// planes hold a frozen row's rates), give the reopened rows iters = max_iter,
// zero Anderson's history (rip and fpv, adjacent) and count the active rows
// again. Inlined: as a call (__noinline__) it kept the register path at 2
// row tiles from spilling, but slowed every two-phase launch (PERF.md).
__device__ __forceinline__ void phase_boundary(const Params& p, const float* cur, float* rip,
                                            int* flag, int* iters, int* live, int* n_active,
                                            int S, size_t splane) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  for (int s = warp; s < S; s += nwarps) {
    bool keep = false;
    if (p.reopen_at > 0.0f && flag[s] == 2) {
      float peak = -INFINITY;
      for (int i = lane; i < p.n2; i += 32) peak = fmaxf(peak, cur[s * p.ld + i]);
      keep = warp_max(peak) > p.reopen_at;
    }
    __syncwarp();
    if (lane == 0 && !keep) {
      flag[s] = 0;
      iters[s] = p.max_iter;
    }
  }
  if (p.accel)
    for (size_t e = tid; e < 2 * splane; e += nthreads) rip[e] = 0.0f;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < S; ++s) n += flag[s] == 0;
    *n_active = n;
  }
  for (int q = tid; q < p.ntiles; q += nthreads) {
    int n = 0;
    for (int s = q * kTileN; s < min(S, (q + 1) * kTileN); ++s) n += flag[s] == 0;
    live[q] = n;
  }
}

// NT: n8 tiles of rows accumulated together (min(rows / 8, kMaxGroupN));
// more rows are taken in groups of NT. kRegA: the register path, at most
// kRegK / 2 warps, two blocks to an SM. kCluster: p.cluster blocks solve
// one circuit (the header's cluster path). kWGlobal (with kCluster only):
// W is read from device memory in the k-loop, not from shared memory.
// kTwoPhase: the header's two-phase schedule; kRefine (with kTwoPhase): its
// phase 2 in the refinement tail. kPartialSums (with kRefine and kCluster):
// the one-pass loop as independent partial sums (mma_partials_1x; the
// header, Plan::partials).
template <int NT, bool kRegA, bool kCluster, bool kWGlobal, bool kTwoPhase, bool kRefine,
          bool kPartialSums>
__global__ void __launch_bounds__(kRegA ? 32 * kRegK / 2 : kMaxThreads, kRegA ? 2 : 1)
ssn_solve_kernel(const float* __restrict__ W, const float* __restrict__ I,
                 const float* __restrict__ alpha, float* __restrict__ r_out,
                 uint8_t* __restrict__ conv_out, uint8_t* __restrict__ div_out,
                 int* __restrict__ iters_out, Params p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n2 = p.n2, ld = p.ld, rows = p.rows;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this block's neurons: base .. base + own - 1 (all of them without a
  // cluster)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = kCluster ? (int)cluster.block_rank() : 0;
  // this block's circuit b and chunk of rows row0 .. row0 + S - 1
  const int q_circ = kCluster ? blockIdx.x / p.cluster : blockIdx.x;
  const int b = q_circ / p.chunks;
  const int row0 = (q_circ - b * p.chunks) * p.R;
  const int S = min(p.R, p.S_all - row0);
  const int base = kCluster ? rank * p.slab : 0;
  const int own = kCluster ? max(0, min(p.slab, n2 - base)) : n2;
  const int lds = kCluster ? p.lds : ld;
  const size_t plane = (size_t)rows * ld, splane = (size_t)rows * lds;

  static_assert(!kWGlobal || (kCluster && !kRegA), "W-global is a cluster path");
  static_assert(!kRefine || kTwoPhase, "the refinement tail is phase 2");
  static_assert(!kPartialSums || (kRefine && kCluster), "partial sums: the tail's clusters");
  float* Ws = smem;
  float* Is = kWGlobal ? smem : Ws + (size_t)(kCluster ? p.wrows : n2) * ld;
  float* cur = Is + splane;
  float* nxt = cur + plane;
  float* rst = nxt + plane;  // the three Anderson planes exist only if accel
  float* rip = rst + splane;
  float* fpv = rip + splane;
  // the refinement tail's anchor, then its chunk input (Anderson's where it
  // has one)
  float* ua = p.accel ? fpv + splane : rst;
  float* rbase = p.accel ? rst : ua + splane;
  int* flag = reinterpret_cast<int*>(kRefine ? (p.accel ? ua + splane : rbase + splane)
                                             : (p.accel ? fpv + splane : rst));
  int* iters = flag + p.R;
  int* err = iters + p.R;
  int* live = err + rows;
  int* n_active = live + p.ntiles;
  // cluster path with Anderson: per rank and row, the partial num, den and
  // peak of the extrapolated point
  float* xnum = reinterpret_cast<float*>(n_active + 1);
  float* xden = xnum + (size_t)p.cluster * rows;
  float* xpaa = xden + (size_t)p.cluster * rows;

  const size_t n_floats = kWGlobal ? 2 * plane + splane * (p.accel ? 4 : 1)
      : kCluster ? (size_t)p.wrows * ld + 2 * plane + splane * (p.accel ? 4 : 1)
      : (size_t)n2 * ld + plane * (p.accel ? 6 : 3);
  for (size_t e = tid; e < n_floats; e += nthreads) smem[e] = 0.0f;
  __syncthreads();

  const float* Wb = W + ((size_t)b * n2 + base) * n2;
  if constexpr (!kWGlobal) {
    for (int e = tid; e < own * n2; e += nthreads) {
      int i = e / n2, j = e - i * n2;
      Ws[i * ld + j] = Wb[e];
    }
  }
  const float* Ib = I + (size_t)row0 * n2;
  for (int e = tid; e < S * n2; e += nthreads) {
    int s = e / n2, i = e - s * n2;
    float x = Ib[e];
    if (!kCluster || (i >= base && i < base + own)) Is[s * lds + i - base] = x;
    cur[s * ld + i] = p.init_ff ? io_fun(x, p) : 0.0f;
  }
  for (int s = tid; s < rows; s += nthreads) {
    err[s] = 0;
    if (s < S) {
      flag[s] = 0;
      iters[s] = p.max_iter;
    }
  }
  for (int q = tid; q < p.ntiles; q += nthreads) live[q] = min(kTileN, S - q * kTileN);
  if (tid == 0) *n_active = S;

  // This thread's two neurons of the warp's m16 slab (rows g and g + 8 of
  // the accumulator fragment; rows l0 and l1 of this block's Ws, or of its
  // slab of the circuit's W in device memory); neurons past n2 read W as
  // zero and write nothing.
  const int l0 = warp * kTileM + g, l1 = l0 + 8;
  const int i0 = base + l0, i1 = base + l1;
  const bool in0 = i0 < n2, in1 = i1 < n2;
  const float a0 = in0 ? alpha[i0] : 0.0f, a1 = in1 ? alpha[i1] : 0.0f;
  std::conditional_t<kWGlobal, const float*, float*> w0, w1;
  if constexpr (kWGlobal) {
    w0 = Wb + (size_t)(in0 ? l0 : 0) * n2 + t;
    w1 = Wb + (size_t)(in1 ? l1 : 0) * n2 + t;
  } else {
    w0 = Ws + (size_t)(in0 ? l0 : 0) * ld + t;
    w1 = Ws + (size_t)(in1 ? l1 : 0) * ld + t;
  }
  // a warp of the cluster path whose slab lies past n2 has nothing to do
  const bool warp_on = !kCluster || base + warp * kTileM < n2;
  __syncthreads();

  // Register path: split this thread's W fragments once; the high parts
  // stay in registers, the low parts replace W in shared memory (each
  // element belongs to one thread, which alone reads and writes it).
  uint32_t ahr[kRegA ? kRegK : 1][4];
  if constexpr (kRegA) {
#pragma unroll
    for (int kt = 0; kt < kRegK; ++kt) {
      const int j = kt * kTileK;
      const bool live_k = kt < p.ktiles, in4 = j + t + 4 < n2;
      float* wp[4] = {w0 + j, w1 + j, w0 + j + 4, w1 + j + 4};
      const bool ok[4] = {live_k && in0, live_k && in1, live_k && in0 && in4,
                          live_k && in1 && in4};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t lo;
        split_tf32(ok[c] ? *wp[c] : 0.0f, ahr[kt][c], lo);
        if (ok[c]) *wp[c] = __uint_as_float(lo);
      }
    }
  }
  // cluster: every block has set up its shared memory before any peer
  // writes into it
  if constexpr (kCluster)
    cluster.sync();
  else
    __syncthreads();

  int it = 0;
  int nhist = 0;
  // two-phase: in phase 1 (an empty phase 1 when max_iter / 2 is 0)
  bool phase1 = kTwoPhase && p.max_iter1 > 0;
  while (it < p.max_iter && *n_active > 0) {
    for (int sub = 0; sub < p.check_every; ++sub) {
      const bool last = sub == p.check_every - 1;
      // the refinement tail: in phase 2; past substep 0 the rate planes hold
      // the correction e
      const bool tail = kRefine && !phase1;
      const bool corr = tail && sub > 0;
      for (int nb = 0; nb < p.ntiles; nb += NT) {
        bool on[NT];
        bool any = false;
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          on[q] = nb + q < p.ntiles && live[nb + q] > 0;
          any |= on[q];
        }
        if (!any || !warp_on) continue;
        float hh[NT][4], hl[NT][4], lh[NT][4];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) hh[q][c] = hl[q][c] = lh[q][c] = 0.0f;

        const float* rb = cur + (size_t)(nb * kTileN + g) * ld + t;
        bool fast = false;  // phase 1 and the tail's corrections: one TF32 pass
        if constexpr (kTwoPhase) fast = phase1 || corr;
        if (fast) {
          if constexpr (kTwoPhase && kRegA) {
            // the high parts in registers are W's TF32 rounding; the low
            // parts in shared memory are not read
#pragma unroll
            for (int kt = 0; kt < kRegK; ++kt) {
              if (kt >= p.ktiles) break;
              const int j = kt * kTileK;
              mma_kstep_1x<NT>(hh, ahr[kt], rb + j, kTileN * ld, j + t + 4 < n2, on);
            }
          } else if constexpr (kPartialSums) {
            mma_partials_1x<NT, kWGlobal>(hh, w0, w1, rb, kTileN * ld, p.ktiles, n2, t, in0, in1,
                                          on);
          } else if constexpr (kTwoPhase) {
#pragma unroll 2
            for (int kt = 0; kt < p.ktiles; ++kt) {
              const int j = kt * kTileK;
              const bool in4 = j + t + 4 < n2;
              const bool inj = !kWGlobal || j + t < n2;
              const uint32_t ah[4] = {rna_tf32(in0 && inj ? w0[j] : 0.0f),
                                      rna_tf32(in1 && inj ? w1[j] : 0.0f),
                                      rna_tf32(in0 && in4 ? w0[j + 4] : 0.0f),
                                      rna_tf32(in1 && in4 ? w1[j + 4] : 0.0f)};
              mma_kstep_1x<NT>(hh, ah, rb + j, kTileN * ld, in4, on);
            }
          }
        } else if constexpr (kRegA) {
#pragma unroll
          for (int kt = 0; kt < kRegK; ++kt) {
            if (kt >= p.ktiles) break;
            const int j = kt * kTileK;
            const bool in4 = j + t + 4 < n2;  // the last k-step may pass n2
            uint32_t al[4];
            al[0] = in0 ? __float_as_uint(w0[j]) : 0u;
            al[1] = in1 ? __float_as_uint(w1[j]) : 0u;
            al[2] = in0 && in4 ? __float_as_uint(w0[j + 4]) : 0u;
            al[3] = in1 && in4 ? __float_as_uint(w1[j + 4]) : 0u;
            mma_kstep<NT>(hh, hl, lh, ahr[kt], al, rb + j, kTileN * ld, in4, on);
          }
        } else {
#pragma unroll 2
          for (int kt = 0; kt < p.ktiles; ++kt) {
            const int j = kt * kTileK;
            const bool in4 = j + t + 4 < n2;
            // W-global: column j + t may pass n2 at 2N = 2 mod 8, where
            // device memory has no zero padding (shared memory has)
            const bool inj = !kWGlobal || j + t < n2;
            uint32_t ah[4], al[4];
            split_tf32(in0 && inj ? w0[j] : 0.0f, ah[0], al[0]);
            split_tf32(in1 && inj ? w1[j] : 0.0f, ah[1], al[1]);
            split_tf32(in0 && in4 ? w0[j + 4] : 0.0f, ah[2], al[2]);
            split_tf32(in1 && in4 ? w1[j + 4] : 0.0f, ah[3], al[3]);
            mma_kstep<NT>(hh, hl, lh, ah, al, rb + j, kTileN * ld, in4, on);
          }
        }

        // the drive's constant term: I, or the tail's anchor
        const float* ub = Is;
        if constexpr (kRefine)
          if (corr) ub = ua;
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          if (!on[q]) continue;
          // the fragment's four elements: neurons i0, i0, i1, i1 of rows
          // s0, s0 + 1, s0, s0 + 1; computed branch-free, stored where the
          // element exists and its row is active
          const int s0 = (nb + q) * kTileN + 2 * t;
          const bool row_on[2] = {s0 < S && flag[s0 < S ? s0 : 0] == 0,
                                  s0 + 1 < S && flag[s0 + 1 < S ? s0 + 1 : 0] == 0};
          int x[4], xs[4];  // offsets in the rate planes and the slab planes
          bool act[4];
          float r[4], u[4], f[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c < 2 ? i0 : i1;
            x[c] = (s0 + (c & 1)) * ld + (i < n2 ? i : n2 - 1);
            xs[c] = kCluster ? (s0 + (c & 1)) * lds + (i < n2 ? i - base : 0) : x[c];
            act[c] = row_on[c & 1] && i < n2;
            r[c] = cur[x[c]];
            u[c] = hh[q][c] + (hl[q][c] + lh[q][c]) + ub[xs[c]];
          }
          io_fun4(u, f, p);
          float e[2] = {0.0f, 0.0f};  // max |delta| of rows s0, s0 + 1
          if (kRefine && tail) {
            // The refinement tail, in a loop of its own so that the plain
            // loop below compiles as in the kernels without the tail (one
            // loop with a branch per element slowed their phase 1 by up to
            // 14%, PERF.md). r[c]: the correction e, or at substep 0 r_base
            // (e = 0).
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (!act[c]) continue;
              if (sub == 0) {
                ua[xs[c]] = u[c];
                rbase[xs[c]] = r[c];
              }
              const float r0 = sub == 0 ? r[c] : rbase[xs[c]];
              const float e0 = sub == 0 ? 0.0f : r[c];
              const float d = f[c] - __fadd_rn(r0, e0);
              const float en = fminf(__fadd_rn(e0, __fmul_rn(c < 2 ? a0 : a1, d)),
                                     __fsub_rn(p.ceiling, r0));
              const float rn = last ? __fadd_rn(r0, en) : en;
              if constexpr (kCluster)
                store_all(cluster, nxt + x[c], rn, p.cluster);
              else
                nxt[x[c]] = rn;
              e[c & 1] = fmaxf(e[c & 1], fabsf(d));
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (!act[c]) continue;
              const float d = f[c] - r[c];
              if (p.accel && sub == 0) rst[xs[c]] = r[c];
              const float rn = fminf(__fadd_rn(r[c], __fmul_rn(c < 2 ? a0 : a1, d)), p.ceiling);
              if constexpr (kCluster)
                store_all(cluster, nxt + x[c], rn, p.cluster);
              else
                nxt[x[c]] = rn;
              e[c & 1] = fmaxf(e[c & 1], fabsf(d));
            }
          }
          if (last) {
            // max over the 8 lanes (g) that hold the same two columns
            for (int o = 4; o < 32; o <<= 1) {
              e[0] = fmaxf(e[0], __shfl_xor_sync(0xffffffffu, e[0], o));
              e[1] = fmaxf(e[1], __shfl_xor_sync(0xffffffffu, e[1], o));
            }
            if (g == 0) {
              for (int h = 0; h < 2; ++h) {
                const int s = (nb + q) * kTileN + 2 * t + h;
                if (s >= S || flag[s] != 0) continue;
                if constexpr (kCluster) {
                  for (int q2 = 0; q2 < p.cluster; ++q2)
                    atomicMax(cluster.map_shared_rank(err + s, q2), __float_as_int(e[h]));
                } else {
                  atomicMax(err + s, __float_as_int(e[h]));
                }
              }
            }
          }
        }
      }
      // every block's new rates are in every block's next plane, and nobody
      // still reads the plane the next substep overwrites
      if constexpr (kCluster)
        cluster.sync();
      else
        __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // Chunk epilogue: one warp per row.
    const int it_next = it + p.check_every;
    // two-phase: phase 1's residual and budget (the TPU kernel's :298-299)
    const float atol = kTwoPhase && phase1 ? p.coarse : p.atol;
    const int max_it = kTwoPhase && phase1 ? p.max_iter1 : p.max_iter;
    if constexpr (!kCluster) {
      for (int s = warp; s < S; s += nwarps) {
        if (flag[s] != 0) continue;
        float* rc = cur + s * ld;
        const float e = __int_as_float(err[s]);
        float peak = -INFINITY;
        for (int i = lane; i < n2; i += 32) peak = fmaxf(peak, rc[i]);
        peak = warp_max(peak);
        const bool newly_div = peak > p.rate_stop_at;
        const bool newly_conv = !newly_div && e < atol;
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
        // a resolved row is frozen: both rate buffers hold its final rates,
        // so the substeps need not copy it
        if (resolved)
          for (int i = lane; i < n2; i += 32) nxt[s * ld + i] = rc[i];
        __syncwarp();
        if (lane == 0) {
          err[s] = 0;
          if (resolved) {
            flag[s] = newly_div ? 2 : 1;
            // the last chunk may overshoot max_iter by up to check_every - 1
            // substeps; iters == max_iter keeps meaning "unresolved"
            iters[s] = min(it_next, max_it);
          }
        }
      }
    } else {
      // Cluster path: up to three passes over the rows, each row taken by
      // the same warp in every pass. Pass 1: the row's flags from err (the
      // cluster's max |delta|, maxed into every block) and the peak of the
      // full rate plane, kept in err until pass 3 (0 active, 1 converged,
      // 2 diverged); with Anderson, this block's partial num and den go to
      // every block. The peak is read before any block moves a rate.
      const int c = p.cluster;
      for (int s = warp; s < S; s += nwarps) {
        if (flag[s] != 0) continue;
        const float* rc = cur + s * ld;
        const float e = __int_as_float(err[s]);
        float peak = -INFINITY;
        for (int i = lane; i < n2; i += 32) peak = fmaxf(peak, rc[i]);
        peak = warp_max(peak);
        const bool newly_div = peak > p.rate_stop_at;
        const bool newly_conv = !newly_div && e < atol;
        if (p.accel) {
          const float* r_in = rst + s * lds;
          const float* f_prev = fpv + s * lds;
          float num = 0.0f, den = 0.0f;
          for (int l = lane; l < own; l += 32) {
            const float fc = rc[base + l] - r_in[l];
            const float dF = fc - f_prev[l];
            den += dF * dF;
            num += fc * dF;
          }
          den = warp_sum(den);
          num = warp_sum(num);
          if (lane < c) {  // lane q stores into block q
            *cluster.map_shared_rank(xnum + rank * rows + s, lane) = num;
            *cluster.map_shared_rank(xden + rank * rows + s, lane) = den;
          }
        }
        __syncwarp();
        if (lane == 0) err[s] = newly_div ? 2 : newly_conv ? 1 : 0;
      }
      if (p.accel) {
        // Pass 2: gamma from the partials added in rank order (the same
        // bits in every block), and this block's partial peak of the
        // extrapolated point, to every block.
        cluster.sync();
        for (int s = warp; s < S; s += nwarps) {
          if (flag[s] != 0) continue;
          float num = 0.0f, den = 0.0f;
          for (int q = 0; q < c; ++q) {
            num += xnum[q * rows + s];
            den += xden[q * rows + s];
          }
          const float gamma = num / (den + 1e-30f);
          const float* rc = cur + s * ld;
          float peak_aa = -INFINITY;
          for (int l = lane; l < own; l += 32) {
            const float h_prev = rip[s * lds + l] + fpv[s * lds + l];
            const float r = rc[base + l];
            peak_aa = fmaxf(peak_aa, fminf(fmaxf(r - gamma * (r - h_prev), 0.0f), p.ceiling));
          }
          peak_aa = warp_max(peak_aa);
          if (lane < c) *cluster.map_shared_rank(xpaa + rank * rows + s, lane) = peak_aa;
        }
        cluster.sync();
      }
      // Pass 3: Anderson's step on this block's neurons, stored into every
      // block; a resolved row frozen in both rate planes; flags and iters.
      for (int s = warp; s < S; s += nwarps) {
        if (flag[s] != 0) continue;
        float* rc = cur + s * ld;
        const int code = err[s];
        const bool resolved = code != 0;
        if (p.accel) {
          float num = 0.0f, den = 0.0f, peak_aa = -INFINITY;
          for (int q = 0; q < c; ++q) {
            num += xnum[q * rows + s];
            den += xden[q * rows + s];
            peak_aa = fmaxf(peak_aa, xpaa[q * rows + s]);
          }
          const float gamma = num / (den + 1e-30f);
          const bool ok = nhist > 0 && fabsf(gamma) < 2.0f && den > 0.0f &&
                          peak_aa <= p.rate_stop_at && !resolved;
          float* r_in = rst + s * lds;
          float* r_in_prev = rip + s * lds;
          float* f_prev = fpv + s * lds;
          for (int l = lane; l < own; l += 32) {
            const float r = rc[base + l];
            const float fc = r - r_in[l];
            const float h_prev = r_in_prev[l] + f_prev[l];
            if (ok)
              store_all(cluster, rc + base + l,
                        fminf(fmaxf(r - gamma * (r - h_prev), 0.0f), p.ceiling), c);
            r_in_prev[l] = r_in[l];
            f_prev[l] = fc;
          }
        }
        if (resolved)
          for (int i = lane; i < n2; i += 32) nxt[s * ld + i] = rc[i];
        __syncwarp();
        if (lane == 0) {
          err[s] = 0;
          if (resolved) {
            flag[s] = code;
            iters[s] = min(it_next, max_it);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      // the rows that ran this chunk, by phase; in a cluster every block
      // holds the same flags and rank 0 counts them. Once a chunk, not
      // once a block at its end: a count kept to the end would hold two
      // registers of every thread through the substep loop.
      if (p.substeps != nullptr && rank == 0)
        atomicAdd(p.substeps + (phase1 ? 0 : 1),
                  (unsigned long long)*n_active * p.check_every);
      int n = 0;
      for (int s = 0; s < S; ++s) n += flag[s] == 0;
      *n_active = n;
    }
    for (int q = tid; q < p.ntiles; q += nthreads) {
      int n = 0;
      for (int s = q * kTileN; s < min(S, (q + 1) * kTileN); ++s) n += flag[s] == 0;
      live[q] = n;
    }
    it = it_next;
    ++nhist;
    // cluster: Anderson's rates have landed everywhere, and no block's
    // remote writes of the next chunk meet a block still in this epilogue
    if constexpr (kCluster)
      cluster.sync();
    else
      __syncthreads();

    // The phase boundary (the TPU kernel's :314-338): once every row has
    // resolved in phase 1 or its budget is spent (phase_boundary). Every
    // block of a cluster reads the same flags and rates and takes the same
    // branch.
    if constexpr (kTwoPhase) {
      if (phase1 && !(it < p.max_iter1 && *n_active > 0)) {
        phase1 = false;
        nhist = 0;
        phase_boundary(p, cur, rip, flag, iters, live, n_active, S, splane);
        if constexpr (kCluster)
          cluster.sync();
        else
          __syncthreads();
      }
    }
  }

  const size_t out0 = (size_t)b * p.S_all + row0;  // this chunk's first output row
  float* rb = r_out + out0 * n2;
  if constexpr (kCluster) {
    for (int e = tid; e < S * own; e += nthreads) {
      int s = e / own, l = e - s * own;
      rb[s * n2 + base + l] = cur[s * ld + base + l];
    }
    // no block leaves while a peer might still address its shared memory
    cluster.sync();
    if (rank != 0) return;
  } else {
    for (int e = tid; e < S * n2; e += nthreads) {
      int s = e / n2, i = e - s * n2;
      rb[e] = cur[s * ld + i];
    }
  }
  for (int s = tid; s < S; s += nthreads) {
    conv_out[out0 + s] = flag[s] == 1;
    div_out[out0 + s] = flag[s] == 2;
    iters_out[out0 + s] = iters[s];
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        uint8_t*, uint8_t*, int*, Params);

template <bool kRegA, bool kCluster, bool kWGlobal, bool kTwoPhase, bool kRefine,
          bool kPartialSums = false>
Kernel kernel_for_rows(int ntiles) {
  switch (ntiles < kMaxGroupN ? ntiles : kMaxGroupN) {
    case 1: return ssn_solve_kernel<1, kRegA, kCluster, kWGlobal, kTwoPhase, kRefine, kPartialSums>;
    case 2: return ssn_solve_kernel<2, kRegA, kCluster, kWGlobal, kTwoPhase, kRefine, kPartialSums>;
    case 3: return ssn_solve_kernel<3, kRegA, kCluster, kWGlobal, kTwoPhase, kRefine, kPartialSums>;
    default:
      return ssn_solve_kernel<kMaxGroupN, kRegA, kCluster, kWGlobal, kTwoPhase, kRefine,
                              kPartialSums>;
  }
}

template <bool kTwoPhase, bool kRefine>
Kernel kernel_for_path(int n2, int ntiles, int cluster, bool wglobal, bool partials) {
  if constexpr (kRefine)
    if (partials)
      return wglobal ? kernel_for_rows<false, true, true, true, true, true>(ntiles)
                     : kernel_for_rows<false, true, false, true, true, true>(ntiles);
  if (wglobal) return kernel_for_rows<false, true, true, kTwoPhase, kRefine>(ntiles);
  if (cluster > 1) return kernel_for_rows<false, true, false, kTwoPhase, kRefine>(ntiles);
  return n2 <= kRegK * kTileK ? kernel_for_rows<true, false, false, kTwoPhase, kRefine>(ntiles)
                              : kernel_for_rows<false, false, false, kTwoPhase, kRefine>(ntiles);
}

// schedule: 0 one phase, 1 two phases, 2 two phases with the refinement
// tail; partials: its one-pass loop as partial sums (Plan::partials)
Kernel kernel_for(int n2, int S, int cluster, bool wglobal, int schedule, bool partials) {
  const int ntiles = round_up(S, kTileN) / kTileN;
  if (schedule == 2) return kernel_for_path<true, true>(n2, ntiles, cluster, wglobal, partials);
  return schedule ? kernel_for_path<true, false>(n2, ntiles, cluster, wglobal, false)
                  : kernel_for_path<false, false>(n2, ntiles, cluster, wglobal, false);
}

// Neurons per block of a cluster of c: one warp per m16 slab of them.
int slab(int n2, int c) { return round_up((n2 + c - 1) / c, kTileM); }

// The shared-memory layout of the header at cluster size c for R rows: W's
// rows of the block's slab (all n2 at c = 1; none on the W-global path) and
// both rate planes at stride ld, Is, the Anderson planes and (refine) the
// refinement tail's at stride lds (= ld at c = 1), then the ints and, in a
// cluster with Anderson, the per-rank exchange.
size_t layout_bytes(int n2, int R, int accel, int c, int ld, int lds, bool wglobal, bool refine) {
  const size_t rows = round_up(R, kTileN);
  const size_t w = wglobal ? 0 : std::min(slab(n2, c), n2);
  const size_t slab_planes = (accel ? 4 : 1) + (refine ? (accel ? 1 : 2) : 0);
  const size_t floats = w * ld + 2 * rows * ld + rows * lds * slab_planes;
  const size_t ints = 2 * (size_t)R + rows + rows / kTileN + 1 +
                      (c > 1 && accel ? 3 * (size_t)c * rows : 0);
  return (floats + ints) * 4;
}

struct Layout {
  int cluster;  // 0: does not fit
  int ld, lds;
  size_t bytes;
  bool wglobal;  // W read from device memory (the W-global path)
};

// The layout of R rows at cluster size c, with its strides: the least
// stride >= the row length that is 4 mod 8, so that the fragment loads and
// the rate stores hit 32 distinct banks; round_up(length, 4) where that
// padding would not fit (a few rows of floats at tiny N with hundreds of
// rows). cluster = 0 where it does not fit a block (its threads or its
// shared memory), or where W-global is asked at c = 1.
Layout layout_at(int n2, int R, int accel, int c, bool wglobal, bool refine) {
  const int w = std::min(slab(n2, c), n2);
  if (32 * slab(n2, c) / kTileM > kMaxThreads || (wglobal && c == 1))
    return Layout{0, 0, 0, 0, wglobal};
  Layout L{c, round_up(n2 + 4, 8) - 4, round_up(w + 4, 8) - 4, 0, wglobal};
  L.bytes = layout_bytes(n2, R, accel, c, L.ld, L.lds, wglobal, refine);
  if (L.bytes > kMaxSmemBytes) {
    L.ld = round_up(n2, 4);
    L.lds = round_up(w, 4);
    L.bytes = layout_bytes(n2, R, accel, c, L.ld, L.lds, wglobal, refine);
  }
  if (L.bytes > kMaxSmemBytes) L.cluster = 0;
  return L;
}

// The least cluster size whose layout fits R rows (from 2 on the W-global
// path).
Layout layout(int n2, int R, int accel, bool wglobal, bool refine) {
  for (int c : kClusterSizes) {
    const Layout L = layout_at(n2, R, accel, c, wglobal, refine);
    if (L.cluster) return L;
  }
  return Layout{0, 0, 0, 0, wglobal};
}

// The launch plan of an S-row battery (the header's row chunks): K chunks
// of R rows at the layout L. L.cluster = 0: not even an 8-row chunk fits a
// cluster of 8.
struct Plan {
  Layout L;
  int rows, chunks;
  // the refinement tail's one-pass loop as partial sums (set by plan())
  bool partials;
};

// The plan at one kind of layout, W in shared memory or not: the least
// cluster that holds the whole battery, else the least that holds 8 rows
// and the most rows there, balanced over the chunks.
Plan plan_at(int n2, int S, int accel, bool wglobal, bool refine) {
  const Layout whole = layout(n2, S, accel, wglobal, refine);
  if (whole.cluster) return Plan{whole, S, 1};
  const Layout L8 = layout(n2, kTileN, accel, wglobal, refine);
  if (!L8.cluster) return Plan{L8, 0, 0};
  int R = kTileN;  // the most rows, a multiple of 8, that fit at L8's size
  while (layout_at(n2, R + kTileN, accel, L8.cluster, wglobal, refine).cluster) R += kTileN;
  const int K = (S + R - 1) / R;
  R = round_up((S + K - 1) / K, kTileN);
  return Plan{layout_at(n2, R, accel, L8.cluster, wglobal, refine), R, K};
}

// The plan of the header: W in shared memory wherever a cluster of 1, 2, 4
// or 8 holds 8 rows with it, else W from device memory. `rows` > 0 forces
// R (the least cluster that fits it with W in shared memory; none where
// none does); `wglobal` forces W from device memory at the plan's cluster
// size (c > 1), so that the two paths can be held to each other bit for
// bit. `refine`: the same rule on the refinement tail's layout, where the
// one-pass loop runs as partial sums on a cluster whose blocks have at most
// 4 warps (such a layout holds W: one block, one warp a scheduler, an SM)
// or whose W the plan reads from device memory; decided before a forced
// W-global, so that it runs the shared-W launch's sums.
Plan plan(int n2, int S, int accel, int rows, int wglobal, bool refine) {
  Plan P;
  if (rows > 0) {
    P = Plan{layout(n2, rows, accel, false, refine), rows, (S + rows - 1) / rows};
  } else {
    P = plan_at(n2, S, accel, false, refine);
    if (!P.L.cluster) P = plan_at(n2, S, accel, true, refine);
  }
  P.partials = refine && P.L.cluster > 1 && (P.L.wglobal || slab(n2, P.L.cluster) <= 4 * kTileM);
  if (wglobal && P.L.cluster && !P.L.wglobal)
    P.L = layout_at(n2, P.rows, accel, P.L.cluster, true, refine);
  return P;
}

// The launch configuration of `clusters` clusters of L.cluster blocks;
// `attr` backs the cluster attribute.
cudaLaunchConfig_t launch_config(int clusters, int n2, const Layout& L, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * L.cluster);
  cfg.blockDim = dim3(32 * slab(n2, L.cluster) / kTileM);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = L.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan of this shape and its kernel in a schedule (0 one phase, 1 two
// phases, 2 two phases with the refinement tail), with the dynamic shared
// memory admitted.
cudaError_t prepare(int n2, int S, int accel, int rows, int wglobal, int schedule, Plan* P,
                    Kernel* kernel) {
  *P = plan(n2, S, accel, rows, wglobal, schedule == 2);
  if (P->L.cluster == 0) return cudaErrorInvalidValue;
  *kernel = kernel_for(n2, P->rows, P->L.cluster, P->L.wglobal, schedule, P->partials);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)P->L.bytes);
}

}  // namespace

extern "C" {

// Launches the solve of B circuits on `stream` with R = `rows` rows per
// chunk (0: the plan's) and, with `wglobal`, W read from device memory at
// the plan's cluster size, in a `schedule`: 0 one phase; 1 the header's
// two-phase schedule, phase 1 to `coarse` within `max_iter1` substeps,
// phase-1 diverged rows whose peak passes `reopen_at` (> 0) kept diverged;
// 2 the same with phase 2 in the refinement tail (and its layout's plan).
// `substeps`: null, or two int64 totals on the device to which the launch
// adds the substeps its rows ran in phase 1 and in phase 2 (in one phase,
// all in phase 2), counted a chunk of check_every substeps at a time.
// `plan_out`: null, or five ints in host memory that receive the plan the
// launch takes: {cluster size, rows per chunk, chunks, W-global, the
// one-pass loop as partial sums}.
// Returns the cudaError_t of the attribute call, of the cluster occupancy
// check (cluster sizes > 1: cudaErrorLaunchOutOfResources when not one
// cluster fits the device) or of the launch (cudaGetLastError), 0 on
// success; cudaErrorInvalidValue when no layout fits.
int ssn_solve_run(const void* W, const void* I, const void* alpha, void* r, void* conv,
                  void* div, void* iters, int B, int n2, int S, int io_type, float k, float n,
                  float r0, float r1, float u0, float slope, float atol, float rate_stop_at,
                  float ceiling, int max_iter, int check_every, int init_ff, int accel,
                  void* stream, int rows, int wglobal, int schedule, float coarse,
                  int max_iter1, float reopen_at, void* substeps, int* plan_out) {
  Plan P;
  Kernel kernel;
  cudaError_t err = prepare(n2, S, accel, rows, wglobal, schedule, &P, &kernel);
  if (err != cudaSuccess) return (int)err;
  if (plan_out) {
    plan_out[0] = P.L.cluster;
    plan_out[1] = P.rows;
    plan_out[2] = P.chunks;
    plan_out[3] = P.L.wglobal;
    plan_out[4] = P.partials;
  }
  const Layout& L = P.L;
  Params p;
  p.n2 = n2;
  p.S_all = S;
  p.R = P.rows;
  p.chunks = P.chunks;
  p.ld = L.ld;
  p.rows = round_up(P.rows, kTileN);
  p.ktiles = round_up(n2, kTileK) / kTileK;
  p.ntiles = p.rows / kTileN;
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
  p.cluster = L.cluster;
  p.slab = slab(n2, L.cluster);
  p.lds = L.lds;
  p.wrows = L.wglobal ? 0 : std::min(p.slab, n2);
  p.coarse = coarse;
  p.reopen_at = reopen_at;
  p.max_iter1 = max_iter1;
  p.substeps = static_cast<unsigned long long*>(substeps);
  const float* Wf = static_cast<const float*>(W);
  const float* If = static_cast<const float*>(I);
  const float* af = static_cast<const float*>(alpha);
  float* rf = static_cast<float*>(r);
  uint8_t* cf = static_cast<uint8_t*>(conv);
  uint8_t* df = static_cast<uint8_t*>(div);
  int* itf = static_cast<int*>(iters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int clusters = B * P.chunks;
  if (L.cluster == 1) {
    kernel<<<clusters, 32 * slab(n2, 1) / kTileM, L.bytes, st>>>(Wf, If, af, rf, cf, df, itf, p);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(clusters, n2, L, st, &attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, Wf, If, af, rf, cf, df, itf, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of this shape in a schedule (0 one phase, 1 two phases, 2 two
// phases with the refinement tail, whose layout may plan otherwise) and its
// kernel's occupancy on the current device: out = {cluster size, rows per
// chunk, chunks, W-global, dynamic shared memory per block, blocks per SM,
// chunks at once (clusters; at cluster size 1, blocks per SM times SMs),
// the one-pass loop as partial sums}.
// Returns 0, cudaErrorInvalidValue where no layout fits, or the cudaError_t
// of a query that failed.
int ssn_solve_query(int n2, int S, int accel, int schedule, int* out) {
  Plan P;
  Kernel kernel;
  cudaError_t err = prepare(n2, S, accel, 0, 0, schedule, &P, &kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = P.L.cluster;
  out[1] = P.rows;
  out[2] = P.chunks;
  out[3] = P.L.wglobal;
  out[4] = (int)P.L.bytes;
  out[7] = P.partials;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], kernel, 32 * slab(n2, P.L.cluster) / kTileM, P.L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (P.L.cluster == 1) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    out[6] = out[5] * sms;
    return (int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(P.L.cluster, n2, P.L, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(&out[6], reinterpret_cast<const void*>(kernel),
                                             &cfg);
}

const char* ssn_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
