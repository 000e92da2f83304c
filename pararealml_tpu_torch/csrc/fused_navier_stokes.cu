// The fused RK4 kernel of the 2D vorticity-stream-function Navier-Stokes
// system on Cartesian meshes with static boundary conditions, for Hopper
// (sm_90a).
//
// Replaces the Navier-Stokes branch of the JAX package's Pallas TPU
// kernels of ops/fused_system.py (K5): build_fused_system_rk4_trajectory
// (every step stored), build_fused_system_rk4_end (end state, single or
// batched) and build_fused_system_rk4_step (one step: the trajectory with
// n_steps = 1), whose step is the Navier-Stokes branch of
// _make_step_factory. A state is (w, psi, u, v): vorticity, stream
// function and velocities. One step computes, term for term and in the
// same order as that branch over its _StencilHelpers (the helpers of
// system_2d.cuh),
//   f(w, u, v) = ((nu lap(w) - u d0(w)) - v d1(w)),
//   k1 = f(w, u, v), k2 = f(D0(w + (d_t/2) k1), D2(u), D3(v)),
//   k3 = f(D0(w + (d_t/2) k2), D2(u), D3(v)), k4 = f(D0(w + d_t k3), ...),
//   w' = D0(w + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
//   u' = D2(d1(psi)), v' = D3(-d0(psi)) from the step-initial psi,
//   psi' = the Jacobi solve of lap(psi') = -w from D1(psi): sweeps
//     psi <- D1(psi + (lap(psi) - (-w)) / (2/dx0^2 + 2/dx1^2))
//   while the 2-norm of the last sweep's update is above tol and fewer
//   than max_iterations sweeps have run (at least one unless
//   max_iterations is 0), with D the per-component Dirichlet override. The
//   norm is taken over the H x W cells; its sum of squares is accumulated
//   in double (each square of a float update is exact there), so that the
//   plain PyTorch version, which sums in another order, takes the same
//   branch; the JAX kernel sums in float32.
//
// What bounds it on the card: neither bytes nor FLOPs but the loop's
// dependent steps. On the example's 101 x 81 grid a step is four RK4
// stages and some 17 Jacobi sweeps on average (700 in the first step),
// each a few shared-memory loads and about 15 operations a cell, and the
// solve may stop after any sweep on a norm over the whole grid: 2,000
// steps hold 33,163 sweeps, against 262 MB of frames (78 us at 3.35 TB/s)
// and some 5 GFLOP (75 us at 67 TFLOP/s).
//
// What the design does about it. The state stays on-chip for all
// n_steps, as on the TPU, where one core's VMEM held the whole grid. On
// Hopper it does not fit one block's 227 KB, so one thread block cluster
// of 1, 2, 4 or 8 blocks holds one state, as the 3D kernel K9 does
// (fused_system_3d.cu). Its blocks split axis 0 into slabs of rows; each
// keeps its slab's state, two stage buffers and the RK4 accumulator of w,
// the Dirichlet values and byte masks in its own shared memory for the
// whole solve. A stage reads a neighbour across a slab edge from the
// neighbouring block's shared memory through distributed shared memory
// (cooperative_groups::this_cluster().map_shared_rank), and one
// cluster.sync() closes each stage and each step (a stage reads one
// buffer and writes another: state -> stage_a -> stage_b -> stage_a ->
// stage_b).
//
// The Jacobi sweeps run in groups of K (a template parameter, the plan's
// group; blocks of up to 512 threads take instances with twice the
// registers a thread) between cluster barriers:
// - Three stream-function buffers, each the slab plus K guard rows above
//   and below it, rotate through the solve as the group's start buffer S
//   and two work buffers: the state's psi, stage_a and the accumulator,
//   which the RK4 stages no longer need then. The solve starts from
//   D1(psi), which the last stage writes over the accumulator. w's plane
//   and psi's Dirichlet planes have the guard rows too.
// - At a group's start each block copies, once, the K rows of S next to
//   its slab from each neighbour through distributed shared memory (and,
//   in a step's first group, those of w, the right-hand side; psi's
//   Dirichlet rows were loaded with the slab). It then runs the group's
//   sweeps over its slab and a halo that shrinks by one row a sweep (sweep
//   t = 0, ..., K - 1 covers K - 1 - t rows past each slab edge that has a
//   neighbour), separated by __syncthreads only. A halo cell runs the same
//   operations on the same inputs as the neighbour's own cell, so it is
//   bit for bit equal to it. K is at most the smallest slab's rows, so a
//   halo comes from the adjacent blocks only. Guard rows past the grid's
//   faces hold zeros, which is what the whole-grid helpers read there.
// - Each thread sums the squares of its own-row cells' updates, one sum a
//   sweep, in registers. At the group's end each warp reduces them by
//   shuffles, warp 0 reduces the warps' sums by shuffles in a fixed order,
//   and the block's sum of each sweep goes into its own slot. One cluster
//   barrier closes the group. Then every warp reads the group's slots of
//   every rank through distributed shared memory, one a lane, adds each
//   sweep's in rank order by shuffles and finds by a ballot the first
//   sweep after which the norm is at most tol, so every block takes the
//   same branch; a group runs no more sweeps than max_iterations leaves.
// - Sweeps computed past the stopping sweep are discarded and not counted.
//   The stopping sweep's psi is still in its work buffer when it is one of
//   the group's last two sweeps; otherwise the block replays the group up
//   to it from S, which no sweep writes, on the same rows and buffers. The
//   step's end copies it into the state's psi plane if it is elsewhere.
// Why the order is free of races: within a group every block reads S and
// writes only its own work buffers, so no block overwrites rows that a
// neighbour still copies; S becomes a work buffer in the next group at
// the earliest, after the barrier that ends every block's copy. The slots
// alternate between two sets by group: a block writes a set again only
// after a barrier that every block passes after reading it. After a
// solve's last barrier no block reads another's stream-function buffers
// until the step's end has passed its barrier. Each state counts its
// sweeps into a 64-bit device counter, from which the bound is reckoned.
//
// A batch of states is the grid: one cluster per state, each with its
// own sweeps (Parareal's fine ends). The trajectory is stored in the JAX
// package's (..., steps, H, W, 4) layout, a thread writing its cells' four
// values as one 16-byte store. The host refuses, without launching, a
// cluster the card cannot place (cudaOccupancyMaxActiveClusters).
// Later work: the stages' cluster barriers (one a stage and one a step's
// end remain), thread-owned cells with their Dirichlet data and
// right-hand side in registers as in K5, and warp-level sweeps.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "system_2d.cuh"

namespace cg = cooperative_groups;

namespace {

using system2d::Cell;
using system2d::Faces;
using system2d::Neighbours;
using system2d::Params;
using system2d::WholeGrid;

constexpr int kMaxThreads = 1024;
constexpr int kComponents = 4;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;

// The doubles at the start of shared memory for groups of `group`
// sweeps: two sets of one slot a sweep, and each warp's sum of each
// sweep.
__host__ __device__ constexpr int reduction_doubles(int group) {
  return 2 * group + kMaxWarps * group;
}

// The rows kept above and below a slab: the group's halo, or one row of
// zeros past the grid's faces for a cluster of one block.
__host__ __device__ constexpr int guard_rows(int group, int cluster_size) {
  return cluster_size > 1 ? group : 1;
}

// A block's shared memory (shared_memory_bytes_2d in
// ops/fused_navier_stokes.py computes the same): the reduction's doubles;
// five float planes of the slab and its guard rows (the three
// stream-function buffers, w, psi's Dirichlet values); six of the slab (u,
// v, stage_b, the Dirichlet values of w, u and v); one byte plane with the
// guard rows (psi's Dirichlet mask) and three of the slab (the others').
__host__ __device__ constexpr size_t shared_bytes_2d(int slab, int width,
                                                     int group,
                                                     int cluster_size) {
  return 8 * static_cast<size_t>(reduction_doubles(group)) +
         static_cast<size_t>(slab + 2 * guard_rows(group, cluster_size)) *
             width * (5 * 4 + 1) +
         static_cast<size_t>(slab) * width * (6 * 4 + 3);
}

// The sweep split (tools/ns_sweep_split.py builds this source with
// -DNS_SWEEP_SPLIT): lane 0 of every warp of block 0 (rank 0 of state 0)
// adds the clock64() cycles it spends in each segment (kSplitSegments:
// the stages' arithmetic, their cluster barriers, the halo copy, the
// sweeps' stencil and update, the in-block reduction, the group's cluster
// barrier, the remote partial reads and decision, the replay, the step's
// end and its barrier) to the buffer ns_split_sums points to, then the
// sweeps it computed and replayed and the groups it ran, kSplitColumns a
// warp; its thread 0 records the globaltimer and clock64() at the step
// loop's start and end in ns_split_clock. Without the macro the marks
// compile to nothing.
constexpr int kSplitSegments = 10;
constexpr int kSplitColumns = kSplitSegments + 3;
#ifdef NS_SWEEP_SPLIT
__device__ long long* ns_split_sums;
__device__ long long* ns_split_clock;
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}
#define NS_SPLIT_BEGIN                                           \
  const bool split_block = blockIdx.x == 0;                      \
  long long split_sum[kSplitColumns] = {};                       \
  long long split_time = clock64();                              \
  if (split_block && threadIdx.x == 0 && ns_split_clock) {       \
    ns_split_clock[0] = global_ns();                             \
    ns_split_clock[1] = split_time;                              \
  }
#define NS_SPLIT_MARK(segment)                    \
  do {                                            \
    const long long split_now = clock64();        \
    split_sum[segment] += split_now - split_time; \
    split_time = split_now;                       \
  } while (0)
#define NS_SPLIT_COUNT(column, count) \
  split_sum[kSplitSegments + (column)] += (count)
#define NS_SPLIT_END                                                    \
  if (split_block && (threadIdx.x & 31) == 0 && ns_split_sums) {        \
    for (int c = 0; c < kSplitColumns; ++c) {                           \
      ns_split_sums[(threadIdx.x / 32) * kSplitColumns + c] +=          \
          split_sum[c];                                                 \
    }                                                                   \
  }                                                                     \
  if (split_block && threadIdx.x == 0 && ns_split_clock) {              \
    ns_split_clock[2] = global_ns();                                    \
    ns_split_clock[3] = clock64();                                      \
  }
#else
#define NS_SPLIT_BEGIN
#define NS_SPLIT_MARK(segment)
#define NS_SPLIT_COUNT(column, count)
#define NS_SPLIT_END
#endif

struct Args {
  const float* y0;
  float* out;
  long long* sweeps;
  const uint8_t* dir_mask;
  const float* dir_vals;
  Faces faces;
  Params p;
  int n_steps;
  int cluster_size;
  // the most rows one block holds
  int slab;
  float denominator;
  double tol;
  int max_iterations;
};

// This block's rows [row_begin, row_begin + rows) of the grid.
struct Slab {
  int row_begin;
  int rows;
  int cells;
};

// One plane as this block sees it: its own rows and, through distributed
// shared memory, the previous block's last row and the next block's first
// row, or nullptr at the grid's faces.
struct View {
  const float* local;
  const float* prev;
  const float* next;
};

// A plane's value at a cell and its four neighbours, zero outside the
// grid.
__device__ __forceinline__ Neighbours fetch(const View& v, int lc,
                                            const Cell& x, const Slab& s,
                                            const Params& p) {
  const float* plane = v.local;
  const int lr = x.i - s.row_begin;
  Neighbours n;
  n.centre = plane[lc];
  n.above = lr > 0 ? plane[lc - p.width]
                   : (v.prev != nullptr ? v.prev[x.j] : 0.0f);
  n.below = lr < s.rows - 1
                ? plane[lc + p.width]
                : (v.next != nullptr ? v.next[x.j] : 0.0f);
  n.left = x.j > 0 ? plane[lc - 1] : 0.0f;
  n.right = x.j < p.width - 1 ? plane[lc + 1] : 0.0f;
  return n;
}

__device__ __forceinline__ Cell make_cell(int lc, const Slab& s,
                                          const Params& p) {
  Cell x;
  const int lr = lc / p.width;
  x.i = s.row_begin + lr;
  x.j = lc - lr * p.width;
  x.idx = lc;
  return x;
}

// The vorticity's right-hand side at one cell of `w`.
__device__ __forceinline__ float vorticity_rhs(const View& w, int lc,
                                               const Cell& x, const Slab& s,
                                               const Params& p,
                                               const Faces& f, float u,
                                               float v) {
  const Neighbours n = fetch(w, lc, x, s, p);
  return (p.coefficient * system2d::laplacian<WholeGrid>(n, 0, x, p, f) -
          u * system2d::gradient_0(n, 0, x, p, f)) -
         v * system2d::gradient_1<WholeGrid>(n, 0, x, p, f);
}

// One component's Dirichlet override: a byte mask and the values.
struct Dirichlet {
  const uint8_t* mask;
  const float* vals;
  __device__ __forceinline__ float operator()(int lc, float value) const {
    return mask[lc] ? vals[lc] : value;
  }
};

// A barrier over every thread of every block of the cluster, which also
// makes each block's shared-memory writes before it visible to the others.
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// What a Jacobi sweep reads besides its input, as planes with guard rows
// (the right-hand side's w and psi's Dirichlet override), and where this
// thread starts in a range of rows and how far it steps.
struct SweepPlanes {
  const float* w;
  Dirichlet psi;
  // the offset of the slab's first row in a plane with guard rows
  int row_zero;
  int first_row;
  int first_col;
  int row_step;
  int col_step;
};

// One Jacobi sweep of `in` into `out` (planes with guard rows) over the
// slab's rows [lo, hi), negative or past the slab in the guard rows, with
// the Laplacian of the whole-grid helpers at each cell's grid
// coordinates. Returns this thread's sum of squared updates over its cells
// of the slab's own rows (0 without NORM).
template <bool NORM>
__device__ __forceinline__ double sweep(const float* in, float* out,
                                        const SweepPlanes& sp, int lo,
                                        int hi, const Slab& s,
                                        const Params& p, const Faces& f,
                                        float denominator, int threads) {
  const int width = p.width;
  double squares = 0.0;
  int lr = lo + sp.first_row;
  int j = sp.first_col;
  const int end = sp.row_zero + hi * width;
  for (int e = sp.row_zero + lo * width + threadIdx.x; e < end;
       e += threads) {
    Cell x;
    x.i = s.row_begin + lr;
    x.j = j;
    x.idx = e;
    Neighbours n;
    n.centre = in[e];
    n.above = in[e - width];
    n.below = in[e + width];
    n.left = j > 0 ? in[e - 1] : 0.0f;
    n.right = j < width - 1 ? in[e + 1] : 0.0f;
    const float rhs = -sp.w[e];
    const float update =
        (system2d::laplacian<WholeGrid>(n, 1, x, p, f) - rhs) / denominator;
    const float next = sp.psi(e, n.centre + update);
    out[e] = next;
    if (NORM && lr >= 0 && lr < s.rows) {
      const double change = static_cast<double>(next - n.centre);
      squares += change * change;
    }
    j += sp.col_step;
    lr += sp.row_step;
    if (j >= width) {
      j -= width;
      ++lr;
    }
  }
  return squares;
}

// A warp's sum of `value` over its lanes by shuffles, in lane 0.
__device__ __forceinline__ double warp_sum(double value) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    value += __shfl_down_sync(0xffffffffu, value, offset);
  }
  return value;
}

// One cluster of cluster_size blocks advances state blockIdx.x /
// cluster_size of `y0` ((B, H, W, 4), row-major) by n_steps steps, with
// Jacobi sweeps in groups of K. WRITE_TRAJECTORY: out is (B, n_steps, H,
// W, 4) and receives every step; otherwise out is (B, H, W, 4) and
// receives the end. dir_mask and dir_vals are the Dirichlet grids (4, H,
// W); sweeps[b] receives the state's number of Jacobi sweeps over all
// steps.
template <bool WRITE_TRAJECTORY, int K, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    fused_navier_stokes_rk4_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Params& p = a.p;
  const Faces& f = a.faces;
  const int cluster_size = a.cluster_size;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / cluster_size;
  const int width = p.width;

  Slab s;
  s.row_begin = rank * p.height / cluster_size;
  s.rows = (rank + 1) * p.height / cluster_size - s.row_begin;
  s.cells = s.rows * width;
  const int guard = guard_rows(K, cluster_size);
  // the floats of a plane of the slab, and of one with its guard rows
  const int stride = a.slab * width;
  const int guarded = (a.slab + 2 * guard) * width;
  const int row_zero = guard * width;
  const size_t plane = static_cast<size_t>(p.height) * width;
  const size_t slab_offset = static_cast<size_t>(s.row_begin) * width;

  // layout (shared_bytes_2d): the reduction's doubles, the guarded float
  // planes, the slab's float planes, the guarded mask, the slab's masks
  extern __shared__ __align__(16) double shared[];
  double* partials = shared;
  double* warp_sums = shared + 2 * K;
  float* psi_buffers =
      reinterpret_cast<float*>(shared + reduction_doubles(K));
  float* w_guarded = psi_buffers + 3 * guarded;
  float* psi_vals = w_guarded + guarded;
  float* slab_planes = psi_vals + guarded;
  uint8_t* psi_mask = reinterpret_cast<uint8_t*>(slab_planes + 6 * stride);
  uint8_t* slab_masks = psi_mask + guarded;
  // each plane from its slab's first row; the state's psi, stage_a and
  // the accumulator are the three stream-function buffers
  float* const psi = psi_buffers + row_zero;
  float* const stage_a = psi_buffers + guarded + row_zero;
  float* const acc = psi_buffers + 2 * guarded + row_zero;
  float* const w = w_guarded + row_zero;
  float* const u = slab_planes;
  float* const v = slab_planes + stride;
  float* const stage_b = slab_planes + 2 * stride;
  const Dirichlet dirichlet[kComponents] = {
      {slab_masks, slab_planes + 3 * stride},
      {psi_mask + row_zero, psi_vals + row_zero},
      {slab_masks + stride, slab_planes + 4 * stride},
      {slab_masks + 2 * stride, slab_planes + 5 * stride},
  };

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  // the guarded planes read as zero where no slab or halo fills them:
  // zeroed first, then the slab and psi's Dirichlet rows within the grid
  // loaded
  for (int e = tid; e < 5 * guarded; e += threads) psi_buffers[e] = 0.0f;
  for (int e = tid; e < guarded; e += threads) psi_mask[e] = 0;
  __syncthreads();
  // the state arrives interleaved ((H, W, 4)) and is kept as planes
  const float4* y_in = reinterpret_cast<const float4*>(a.y0) +
                       b * plane + slab_offset;
  for (int lc = tid; lc < s.cells; lc += threads) {
    const float4 y = y_in[lc];
    w[lc] = y.x;
    psi[lc] = y.y;
    u[lc] = y.z;
    v[lc] = y.w;
  }
  // the Dirichlet planes of w, u and v (components 0, 2, 3) over the slab
  for (int slot = 0; slot < 3; ++slot) {
    const size_t base = (slot == 0 ? 0 : slot + 1) * plane + slab_offset;
    for (int lc = tid; lc < s.cells; lc += threads) {
      slab_planes[(3 + slot) * stride + lc] = a.dir_vals[base + lc];
      slab_masks[slot * stride + lc] = a.dir_mask[base + lc];
    }
  }
  // psi's over the slab and its guard rows within the grid
  {
    const int first = max(s.row_begin - guard, 0);
    const int last = min(s.row_begin + s.rows + guard, p.height);
    const size_t base = plane + static_cast<size_t>(first) * width;
    const int offset = (first - s.row_begin + guard) * width;
    for (int e = tid; e < (last - first) * width; e += threads) {
      psi_vals[offset + e] = a.dir_vals[base + e];
      psi_mask[offset + e] = a.dir_mask[base + e];
    }
  }
  // every block of the cluster has started and loaded its slab before any
  // reads a neighbour's shared memory
  cluster_barrier();

  const bool has_prev = rank > 0;
  const bool has_next = rank < cluster_size - 1;
  const int prev_rows =
      has_prev ? s.row_begin - (rank - 1) * p.height / cluster_size : 0;
  auto view = [&](float* own) {
    View vw;
    vw.local = own;
    vw.prev = has_prev ? cluster.map_shared_rank(own, rank - 1) +
                             (prev_rows - 1) * width
                       : nullptr;
    vw.next = has_next ? cluster.map_shared_rank(own, rank + 1) : nullptr;
    return vw;
  };
  const View w_in = view(w);
  const View psi_in = view(psi);
  const View stage_a_in = view(stage_a);
  const View stage_b_in = view(stage_b);
  SweepPlanes sp;
  sp.w = w_guarded;
  sp.psi = {psi_mask, psi_vals};
  sp.row_zero = row_zero;
  sp.first_row = tid / width;
  sp.first_col = tid - sp.first_row * width;
  sp.row_step = threads / width;
  sp.col_step = threads - sp.row_step * width;
  // sweep t of a group covers K - 1 - t halo rows on each side that has a
  // neighbour
  auto rows_lo = [&](int t) { return has_prev ? t + 1 - K : 0; };
  auto rows_hi = [&](int t) {
    return has_next ? s.rows + K - 1 - t : s.rows;
  };
  auto buffer = [&](int index) { return psi_buffers + index * guarded; };
  long long total_sweeps = 0;
  int set = 0;

  NS_SPLIT_BEGIN
  for (int step = 0; step < a.n_steps; ++step) {
    // stage 0: k1 from the state's w, u and v
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(w_in, lc, x, s, p, f, u[lc], v[lc]);
      acc[lc] = k;
      stage_a[lc] = dirichlet[0](lc, w[lc] + p.half_d_t * k);
    }
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    // stages 1 and 2, with the velocities' Dirichlet values
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_a_in, lc, x, s, p, f,
                                    dirichlet[2](lc, u[lc]),
                                    dirichlet[3](lc, v[lc]));
      acc[lc] = acc[lc] + 2.0f * k;
      stage_b[lc] = dirichlet[0](lc, w[lc] + p.half_d_t * k);
    }
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_b_in, lc, x, s, p, f,
                                    dirichlet[2](lc, u[lc]),
                                    dirichlet[3](lc, v[lc]));
      acc[lc] = acc[lc] + 2.0f * k;
      stage_a[lc] = dirichlet[0](lc, w[lc] + p.d_t * k);
    }
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    // stage 3: w' into stage_b (w stays the solve's right-hand side), the
    // velocities from the step-initial psi (each thread rewrites only its
    // own cells of u and v, which no block reads across cells), and
    // D1(psi), the Jacobi solve's start, over the accumulator (each thread
    // reads its own cell of it first)
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_a_in, lc, x, s, p, f,
                                    dirichlet[2](lc, u[lc]),
                                    dirichlet[3](lc, v[lc]));
      stage_b[lc] = dirichlet[0](lc, w[lc] + p.sixth_d_t * (acc[lc] + k));
      const Neighbours n = fetch(psi_in, lc, x, s, p);
      u[lc] = dirichlet[2](lc,
                           system2d::gradient_1<WholeGrid>(n, 1, x, p, f));
      v[lc] = dirichlet[3](lc, -system2d::gradient_0(n, 1, x, p, f));
      acc[lc] = dirichlet[1](lc, psi[lc]);
    }
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);

    // the Jacobi solve of lap(psi') = -w, from buffer 2 (the accumulator)
    int start = 2;
    int result = 2;
    int iterations = 0;
    bool first_group = true;
    while (iterations < a.max_iterations) {
      const int group = min(K, a.max_iterations - iterations);
      float* const s_buffer = buffer(start);
      float* const work[2] = {buffer((start + 1) % 3),
                              buffer((start + 2) % 3)};
      // the halo: the neighbours' K rows of S next to the slab (and, in
      // the step's first group, of w)
      if (cluster_size > 1) {
        const int halo = K * width;
        const float* prev_s =
            has_prev ? cluster.map_shared_rank(s_buffer, rank - 1) +
                           (guard + prev_rows - K) * width
                     : nullptr;
        const float* next_s =
            has_next ? cluster.map_shared_rank(s_buffer, rank + 1) + row_zero
                     : nullptr;
        const float* prev_w = has_prev ? w_in.prev - (K - 1) * width : nullptr;
        float* const upper_s = s_buffer + row_zero - halo;
        float* const lower_s = s_buffer + row_zero + s.cells;
        for (int e = tid; e < halo; e += threads) {
          if (has_prev) upper_s[e] = prev_s[e];
          if (has_next) lower_s[e] = next_s[e];
          if (first_group) {
            if (has_prev) w[e - halo] = prev_w[e];
            if (has_next) w[s.cells + e] = w_in.next[e];
          }
        }
        __syncthreads();
      }
      first_group = false;
      NS_SPLIT_MARK(2);
      // the group's sweeps, each thread's sums of squares in registers
      double squares[K];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        squares[t] = 0.0;
        if (t < group) {
          if (t > 0) __syncthreads();
          squares[t] = sweep<true>(t == 0 ? s_buffer : work[(t - 1) & 1],
                                   work[t & 1], sp, rows_lo(t), rows_hi(t),
                                   s, p, f, a.denominator, threads);
        }
      }
      NS_SPLIT_MARK(3);
      NS_SPLIT_COUNT(0, group);
      // the block's sum of each sweep: each warp's by shuffles, then warp
      // 0's over the warps' sums by shuffles, into this group's slots
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const double sum = warp_sum(squares[t]);
        if (lane == 0) warp_sums[t * kMaxWarps + warp] = sum;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const double sum = warp_sum(
              lane < warps ? warp_sums[t * kMaxWarps + lane] : 0.0);
          if (lane == 0) partials[set * K + t] = sum;
        }
      }
      NS_SPLIT_MARK(4);
      cluster_barrier();
      NS_SPLIT_MARK(5);
      // the first sweep of the group after which the norm is at most tol,
      // found by every warp alike: lane l reads the group's slot l (rank
      // l / K, sweep l % K) through distributed shared memory, lane t < K
      // adds sweep t's slots by shuffles in rank order, and the ballot of
      // the lanes whose norm is at most tol gives the first
      constexpr int kSlotsALane = (K * kMaxCluster + 31) / 32;
      const int slots = K * cluster_size;
      double slot[kSlotsALane];
#pragma unroll
      for (int i = 0; i < kSlotsALane; ++i) {
        const int index = lane + 32 * i;
        slot[i] = index < slots ? cluster.map_shared_rank(partials,
                                                          index / K)[set * K +
                                                                     index % K]
                                : 0.0;
      }
      double total = 0.0;
      for (int r = 0; r < cluster_size; ++r) {
        const int index = r * K + lane % K;
        double value = 0.0;
#pragma unroll
        for (int i = 0; i < kSlotsALane; ++i) {
          const double shuffled = __shfl_sync(0xffffffffu, slot[i], index & 31);
          if (index / 32 == i) value = shuffled;
        }
        total += value;
      }
      const unsigned stops = __ballot_sync(
          0xffffffffu, lane < group && !(sqrt(total) > a.tol));
      const int stop = __ffs(static_cast<int>(stops));
      set ^= 1;
      NS_SPLIT_MARK(6);
      NS_SPLIT_COUNT(2, 1);
      if (stop == 0) {
        // no stop in the group: its last sweep's psi starts the next
        iterations += group;
        start = (start + 1 + ((group - 1) & 1)) % 3;
        result = start;
        continue;
      }
      iterations += stop;
      // the stopping sweep's psi: still in its work buffer when it is one
      // of the group's last two sweeps, else replayed from S
      if (stop < group - 1) {
        for (int t = 0; t < stop; ++t) {
          if (t > 0) __syncthreads();
          sweep<false>(t == 0 ? s_buffer : work[(t - 1) & 1], work[t & 1],
                       sp, rows_lo(t), rows_hi(t), s, p, f, a.denominator,
                       threads);
        }
        __syncthreads();
        NS_SPLIT_COUNT(1, stop);
      }
      NS_SPLIT_MARK(7);
      result = (start + 1 + ((stop - 1) & 1)) % 3;
      break;
    }
    total_sweeps += iterations;

    // the step's end: w' and the solve's psi into the state, and the frame
    const float* const solved = buffer(result) + row_zero;
    float4* frame =
        WRITE_TRAJECTORY
            ? reinterpret_cast<float4*>(a.out) +
                  (b * a.n_steps + step) * plane + slab_offset
            : nullptr;
    for (int lc = tid; lc < s.cells; lc += threads) {
      w[lc] = stage_b[lc];
      if (result != 0) psi[lc] = solved[lc];
      if constexpr (WRITE_TRAJECTORY) {
        frame[lc] = make_float4(w[lc], psi[lc], u[lc], v[lc]);
      }
    }
    NS_SPLIT_MARK(8);
    cluster_barrier();
    NS_SPLIT_MARK(9);
  }
  NS_SPLIT_END
  // the loop ends on a cluster barrier: no neighbour reads this block's
  // shared memory any more, so the block may write its end state and exit
  if (!WRITE_TRAJECTORY) {
    float4* y_out = reinterpret_cast<float4*>(a.out) + b * plane + slab_offset;
    for (int lc = tid; lc < s.cells; lc += threads) {
      y_out[lc] = make_float4(w[lc], psi[lc], u[lc], v[lc]);
    }
  }
  if (rank == 0 && tid == 0) a.sweeps[b] = total_sweeps;
}

template <int K, int MAX_THREADS>
const void* select_output(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   fused_navier_stokes_rk4_kernel<true, K, MAX_THREADS>)
             : reinterpret_cast<const void*>(
                   fused_navier_stokes_rk4_kernel<false, K, MAX_THREADS>);
}

// Blocks of up to 512 threads take the instances with twice the registers
// a thread.
template <int K>
const void* select_threads(int threads, int write_trajectory) {
  return threads <= kMaxThreads / 2
             ? select_output<K, kMaxThreads / 2>(write_trajectory)
             : select_output<K, kMaxThreads>(write_trajectory);
}

// The kernel instance for groups of `group` sweeps (1, 2, 3, 4 or 8) in
// blocks of `threads` threads, or nullptr.
const void* select_kernel(int group, int threads, int write_trajectory) {
  switch (group) {
    case 1:
      return select_threads<1>(threads, write_trajectory);
    case 2:
      return select_threads<2>(threads, write_trajectory);
    case 3:
      return select_threads<3>(threads, write_trajectory);
    case 4:
      return select_threads<4>(threads, write_trajectory);
    case 8:
      return select_threads<8>(threads, write_trajectory);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

const char* fused_navier_stokes_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

#ifdef NS_SWEEP_SPLIT
// Points the sweep split's marks at `sums` (kSplitColumns long longs for
// each warp of block 0) and `clock` (four long longs), or turns them off
// (null).
int fused_navier_stokes_split_buffers(void* sums, void* clock) {
  long long* sums_pointer = static_cast<long long*>(sums);
  long long* clock_pointer = static_cast<long long*>(clock);
  cudaError_t error = cudaMemcpyToSymbol(ns_split_sums, &sums_pointer,
                                         sizeof(sums_pointer));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaMemcpyToSymbol(ns_split_clock, &clock_pointer,
                                             sizeof(clock_pointer)));
}

int fused_navier_stokes_split_columns() { return kSplitColumns; }
#endif

// Launches one cluster of cluster_size blocks of `threads` threads per
// state of y0 ((batch, H, W, 4) float32, contiguous, 16-byte aligned) on
// `stream`, each running its Jacobi sweeps in groups of `group` (1, 2, 3,
// 4 or 8; with more than one block, at most the fewest rows a block
// holds). Each block holds a slab of at most `slab` rows in `shared_bytes`
// of dynamic shared memory, as the caller's cluster plan sizes them
// (shared_memory_bytes_2d in ops/fused_navier_stokes.py, which must equal
// shared_bytes_2d). coefficients are the 15 of system2d::make_params (d_t
// / 2, d_t, d_t / 6, 1 / Re, four unused, ...); denominator is 2 / dx0^2
// + 2 / dx1^2; each step's Jacobi solve stops once its update norm is at
// most tol or after max_iterations sweeps. sweeps ((batch,) int64)
// receives each state's total sweeps. Returns cudaErrorInvalidValue for a
// plan the kernel does not take, cudaErrorCooperativeLaunchTooLarge,
// without launching, when the card cannot place one such cluster, else the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else than 0.
int fused_navier_stokes_rk4(const float* y0, float* out, long long* sweeps,
                            int batch, int height, int width, int n_steps,
                            int write_trajectory, int cluster_size, int slab,
                            int group, int threads, size_t shared_bytes,
                            const uint8_t* dir_mask, const float* dir_vals,
                            const uint8_t* ghost_row_mask,
                            const float* ghost_row_vals,
                            const uint8_t* ghost_col_mask,
                            const float* ghost_col_vals,
                            const float* coefficients, float denominator,
                            double tol, int max_iterations, void* stream) {
  const void* kernel = select_kernel(group, threads, write_trajectory);
  if (kernel == nullptr || batch <= 0 || n_steps <= 0 || height < 3 ||
      width < 3 ||
      !(cluster_size == 1 || cluster_size == 2 || cluster_size == 4 ||
        cluster_size == 8) ||
      height < cluster_size ||
      slab < (height + cluster_size - 1) / cluster_size ||
      (cluster_size > 1 && group > height / cluster_size) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || max_iterations < 0 ||
      shared_bytes != shared_bytes_2d(slab, width, group, cluster_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  Args a;
  a.y0 = y0;
  a.out = out;
  a.sweeps = sweeps;
  a.dir_mask = dir_mask;
  a.dir_vals = dir_vals;
  a.faces.grm = ghost_row_mask;
  a.faces.grv = ghost_row_vals;
  a.faces.gcm = ghost_col_mask;
  a.faces.gcv = ghost_col_vals;
  a.faces.n = kComponents;
  a.faces.inv_r = nullptr;
  a.p = system2d::make_params(height, width, coefficients);
  a.n_steps = n_steps;
  a.cluster_size = cluster_size;
  a.slab = slab;
  a.denominator = denominator;
  a.tol = tol;
  a.max_iterations = max_iterations;

  cudaError_t error = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (error != cudaSuccess) return static_cast<int>(error);

  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster_size;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * cluster_size);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attribute;
  config.numAttrs = 1;

  // a cluster whose blocks the card cannot hold at once would never start:
  // refuse it instead
  int clusters = 0;
  error = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (error != cudaSuccess) return static_cast<int>(error);
  if (clusters < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }

  void* args[] = {&a};
  error = cudaLaunchKernelExC(&config, kernel, args);
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
