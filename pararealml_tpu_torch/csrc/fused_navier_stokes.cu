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
//   until the 2-norm of a sweep's update is at most tol or max_iterations
//   sweeps have run (at least one), with D the per-component Dirichlet
//   override. The norm is taken over the H x W cells; its sum of squares
//   is accumulated in double (each square of a float update is exact
//   there), so that the plain PyTorch version, which sums in another
//   order, takes the same branch; the JAX kernel sums in float32.
//
// What bounds it on the card: neither bytes nor FLOPs but the loop's
// dependent steps. On the example's 101 x 81 grid a step is four RK4
// stages and some 15 Jacobi sweeps (700 in the first step), each a few
// shared-memory loads and about 10 operations a cell, and each sweep ends
// in a norm over the whole grid that decides whether the next one runs: a
// barrier across the cluster. 2,000 steps are about 41,000 such barriers,
// against 262 MB of frames (78 us at 3.35 TB/s) and some 5 GFLOP (75 us
// at 67 TFLOP/s).
//
// What the design does about it: the state stays on-chip for all
// n_steps, as on the TPU, where one core's VMEM held the whole grid. On
// Hopper the working set (12 floats and 4 mask bytes a cell: about 425 KB
// at 101 x 81) does not fit one block's 227 KB, so one thread block
// cluster of 1, 2, 4 or 8 blocks holds one state, as the 3D kernel K9
// does (fused_system_3d.cu). Its blocks split axis 0 into slabs of rows;
// each keeps its slab's state, two stage buffers and the RK4 accumulator
// of w, a second stream-function buffer, the Dirichlet values and byte
// masks in its own shared memory for the whole solve. A neighbour across
// a slab edge is read from the neighbouring block's shared memory through
// distributed shared memory (cooperative_groups::this_cluster()
// .map_shared_rank), and cluster.sync() separates the stages. A stage
// reads one buffer and writes another (state -> stage_a -> stage_b ->
// stage_a -> stage_b), and the Jacobi sweeps alternate between the two
// stream-function buffers, so one barrier a stage or sweep is enough.
//
// The Jacobi loop must take the same branch in every block, or the
// cluster deadlocks in a barrier. Each block reduces its sum of squares
// in a fixed order (each thread's cells in order, the warp by shuffles,
// the warps in order) into one of two slots, alternating by sweep; after
// the sweep's cluster barrier every thread reads the blocks' slots
// through distributed shared memory in rank order and forms the same
// square root. The two slots let the next sweep write its partial while a
// slow block may still read the last one. Each state counts its sweeps
// into a 64-bit device counter, from which the bound is reckoned.
//
// A batch of states is the grid: one cluster per state, each with its
// own sweeps (Parareal's fine ends). The trajectory is stored in the JAX
// package's (..., steps, H, W, 4) layout, a thread writing its cells' four
// values as one 16-byte store. The host refuses, without launching, a
// cluster the card cannot place (cudaOccupancyMaxActiveClusters).
// Several sweeps between norms with an exact replay, and warp-level
// sweeps, are later work.
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
// the doubles at the start of shared memory: two partial-sum slots and
// one sum per warp
constexpr int kReductionDoubles = 2 + kMaxWarps;

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

// This block's rows [row_begin, row_begin + rows) of the grid, kept in
// shared memory as planes of `stride` floats (component c at c * stride).
struct Slab {
  int row_begin;
  int rows;
  int stride;
  int cells;
};

// A buffer as this block sees it: its own planes and, through distributed
// shared memory, the previous block's last row and the next block's first
// row (component 0; the others follow at the stride), or nullptr at the
// grid's faces.
struct View {
  const float* local;
  const float* prev;
  const float* next;
};

// One component's value at a cell and its four neighbours, zero outside
// the grid.
__device__ __forceinline__ Neighbours fetch(const View& v, int comp,
                                            int lc, const Cell& x,
                                            const Slab& s, const Params& p) {
  const int offset = comp * s.stride;
  const float* plane = v.local + offset;
  const int lr = x.i - s.row_begin;
  Neighbours n;
  n.centre = plane[lc];
  n.above = lr > 0 ? plane[lc - p.width]
                   : (v.prev != nullptr ? v.prev[offset + x.j] : 0.0f);
  n.below = lr < s.rows - 1
                ? plane[lc + p.width]
                : (v.next != nullptr ? v.next[offset + x.j] : 0.0f);
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
  const Neighbours n = fetch(w, 0, lc, x, s, p);
  return (p.coefficient * system2d::laplacian<WholeGrid>(n, 0, x, p, f) -
          u * system2d::gradient_0(n, 0, x, p, f)) -
         v * system2d::gradient_1<WholeGrid>(n, 0, x, p, f);
}

// The shared-memory buffers of one block: planes of `stride` floats.
struct Buffers {
  // w, psi, u, v
  float* state;
  // w's stage inputs and RK4 accumulator
  float* stage_a;
  float* stage_b;
  float* acc;
  // the second stream-function buffer of the Jacobi sweeps
  float* psi_b;
  float* dir_vals;
  uint8_t* dir_mask;
};

__device__ __forceinline__ float dirichlet(const Buffers& bf, int comp,
                                           int lc, const Slab& s,
                                           float value) {
  const int e = comp * s.stride + lc;
  return bf.dir_mask[e] ? bf.dir_vals[e] : value;
}

// A barrier over every thread of every block of the cluster, which also
// makes each block's shared-memory writes before it visible to the others.
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// One cluster of cluster_size blocks advances state blockIdx.x /
// cluster_size of `y0` ((B, H, W, 4), row-major) by n_steps steps.
// WRITE_TRAJECTORY: out is (B, n_steps, H, W, 4) and receives every step;
// otherwise out is (B, H, W, 4) and receives the end. dir_mask and
// dir_vals are the Dirichlet grids (4, H, W); sweeps[b] receives the
// state's number of Jacobi sweeps over all steps.
template <bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_navier_stokes_rk4_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Params& p = a.p;
  const Faces& f = a.faces;
  const int cluster_size = a.cluster_size;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / cluster_size;

  Slab s;
  s.row_begin = rank * p.height / cluster_size;
  s.rows = (rank + 1) * p.height / cluster_size - s.row_begin;
  s.stride = a.slab * p.width;
  s.cells = s.rows * p.width;
  const size_t plane = static_cast<size_t>(p.height) * p.width;
  const size_t slab_offset = static_cast<size_t>(s.row_begin) * p.width;

  // layout (sized by shared_memory_bytes_2d in ops/fused_navier_stokes.py):
  // the reduction's doubles, twelve float planes, four byte-mask planes
  extern __shared__ __align__(16) double shared[];
  double* partials = shared;
  double* warp_sums = shared + 2;
  float* planes = reinterpret_cast<float*>(shared + kReductionDoubles);
  Buffers bf;
  bf.state = planes;
  bf.stage_a = bf.state + kComponents * s.stride;
  bf.stage_b = bf.stage_a + s.stride;
  bf.acc = bf.stage_b + s.stride;
  bf.psi_b = bf.acc + s.stride;
  bf.dir_vals = bf.psi_b + s.stride;
  bf.dir_mask = reinterpret_cast<uint8_t*>(bf.dir_vals +
                                           kComponents * s.stride);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  // the state arrives interleaved ((H, W, 4)) and is kept as planes
  const float4* y_in = reinterpret_cast<const float4*>(a.y0) +
                       b * plane + slab_offset;
  for (int lc = tid; lc < s.cells; lc += threads) {
    const float4 y = y_in[lc];
    bf.state[lc] = y.x;
    bf.state[s.stride + lc] = y.y;
    bf.state[2 * s.stride + lc] = y.z;
    bf.state[3 * s.stride + lc] = y.w;
  }
  for (int comp = 0; comp < kComponents; ++comp) {
    const size_t base = comp * plane + slab_offset;
    for (int lc = tid; lc < s.cells; lc += threads) {
      bf.dir_vals[comp * s.stride + lc] = a.dir_vals[base + lc];
      bf.dir_mask[comp * s.stride + lc] = a.dir_mask[base + lc];
    }
  }
  // every block of the cluster has started and loaded its slab before any
  // reads a neighbour's shared memory
  cluster_barrier();

  const int prev_rows =
      rank > 0 ? s.row_begin - (rank - 1) * p.height / cluster_size : 0;
  auto view = [&](float* buffer) {
    View v;
    v.local = buffer;
    v.prev = rank > 0 ? cluster.map_shared_rank(buffer, rank - 1) +
                            (prev_rows - 1) * p.width
                      : nullptr;
    v.next = rank < cluster_size - 1
                 ? cluster.map_shared_rank(buffer, rank + 1)
                 : nullptr;
    return v;
  };
  const View state_in = view(bf.state);
  const View stage_a_in = view(bf.stage_a);
  const View stage_b_in = view(bf.stage_b);
  // the stream function as a one-plane view of each of its two buffers
  const View psi_views[2] = {view(bf.state + s.stride), view(bf.psi_b)};
  const double* remote_partials[8];
  for (int r = 0; r < cluster_size; ++r) {
    remote_partials[r] = cluster.map_shared_rank(partials, r);
  }
  float* const w = bf.state;
  float* const psi = bf.state + s.stride;
  float* const u = bf.state + 2 * s.stride;
  float* const v = bf.state + 3 * s.stride;
  long long total_sweeps = 0;
  int parity = 0;

  for (int step = 0; step < a.n_steps; ++step) {
    // stage 0: k1 from the state's w, u and v
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(state_in, lc, x, s, p, f, u[lc], v[lc]);
      bf.acc[lc] = k;
      bf.stage_a[lc] = dirichlet(bf, 0, lc, s, w[lc] + p.half_d_t * k);
    }
    cluster_barrier();
    // stages 1 and 2, with the velocities' Dirichlet values
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_a_in, lc, x, s, p, f,
                                    dirichlet(bf, 2, lc, s, u[lc]),
                                    dirichlet(bf, 3, lc, s, v[lc]));
      bf.acc[lc] = bf.acc[lc] + 2.0f * k;
      bf.stage_b[lc] = dirichlet(bf, 0, lc, s, w[lc] + p.half_d_t * k);
    }
    cluster_barrier();
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_b_in, lc, x, s, p, f,
                                    dirichlet(bf, 2, lc, s, u[lc]),
                                    dirichlet(bf, 3, lc, s, v[lc]));
      bf.acc[lc] = bf.acc[lc] + 2.0f * k;
      bf.stage_a[lc] = dirichlet(bf, 0, lc, s, w[lc] + p.d_t * k);
    }
    cluster_barrier();
    // stage 3: w' into stage_b (w stays the solve's right-hand side), the
    // velocities from the step-initial psi (each thread rewrites only its
    // own cells of u and v, which no block reads across cells), and
    // D1(psi), the Jacobi solve's start, into psi_b
    for (int lc = tid; lc < s.cells; lc += threads) {
      const Cell x = make_cell(lc, s, p);
      const float k = vorticity_rhs(stage_a_in, lc, x, s, p, f,
                                    dirichlet(bf, 2, lc, s, u[lc]),
                                    dirichlet(bf, 3, lc, s, v[lc]));
      bf.stage_b[lc] = dirichlet(
          bf, 0, lc, s, w[lc] + p.sixth_d_t * (bf.acc[lc] + k));
      const Neighbours n = fetch(state_in, 1, lc, x, s, p);
      u[lc] = dirichlet(bf, 2, lc, s,
                        system2d::gradient_1<WholeGrid>(n, 1, x, p, f));
      v[lc] = dirichlet(bf, 3, lc, s, -system2d::gradient_0(n, 1, x, p, f));
      bf.psi_b[lc] = dirichlet(bf, 1, lc, s, psi[lc]);
    }
    cluster_barrier();

    // the Jacobi solve of lap(psi') = -w, from psi_b
    int current = 1;
    double diff = INFINITY;
    int iterations = 0;
    while (diff > a.tol && iterations < a.max_iterations) {
      const View& in = psi_views[current];
      float* out = current == 1 ? psi : bf.psi_b;
      double squares = 0.0;
      for (int lc = tid; lc < s.cells; lc += threads) {
        const Cell x = make_cell(lc, s, p);
        const Neighbours n = fetch(in, 0, lc, x, s, p);
        const float rhs = -w[lc];
        const float update =
            (system2d::laplacian<WholeGrid>(n, 1, x, p, f) - rhs) /
            a.denominator;
        const float next = dirichlet(bf, 1, lc, s, n.centre + update);
        out[lc] = next;
        const double change = static_cast<double>(next - n.centre);
        squares += change * change;
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        squares += __shfl_down_sync(0xffffffffu, squares, offset);
      }
      if (lane == 0) warp_sums[warp] = squares;
      __syncthreads();
      if (tid == 0) {
        double block = 0.0;
        for (int k = 0; k < warps; ++k) block += warp_sums[k];
        partials[parity] = block;
      }
      cluster_barrier();
      double total = 0.0;
      for (int r = 0; r < cluster_size; ++r) {
        total += remote_partials[r][parity];
      }
      diff = sqrt(total);
      parity ^= 1;
      current ^= 1;
      ++iterations;
    }
    total_sweeps += iterations;

    // the step's end: w' and the solve's psi into the state, and the frame
    float4* frame =
        WRITE_TRAJECTORY
            ? reinterpret_cast<float4*>(a.out) +
                  (b * a.n_steps + step) * plane + slab_offset
            : nullptr;
    for (int lc = tid; lc < s.cells; lc += threads) {
      w[lc] = bf.stage_b[lc];
      if (current == 1) psi[lc] = bf.psi_b[lc];
      if constexpr (WRITE_TRAJECTORY) {
        frame[lc] = make_float4(w[lc], psi[lc], u[lc], v[lc]);
      }
    }
    cluster_barrier();
  }
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

}  // namespace

extern "C" {

const char* fused_navier_stokes_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// Launches one cluster of cluster_size blocks per state of y0 ((batch, H,
// W, 4) float32, contiguous, 16-byte aligned) on `stream`. Each block
// holds a slab of at most `slab` rows in `shared_bytes` of dynamic shared
// memory, as the caller's cluster plan sizes them (shared_memory_bytes_2d
// in ops/fused_navier_stokes.py). coefficients are the 15 of
// system2d::make_params (d_t / 2, d_t, d_t / 6, 1 / Re, four unused, ...);
// denominator is 2 / dx0^2 + 2 / dx1^2; each step's Jacobi solve stops
// once its update norm is at most tol or after max_iterations sweeps.
// sweeps ((batch,) int64) receives each state's total sweeps. Returns
// cudaErrorCooperativeLaunchTooLarge, without launching, when the card
// cannot place one such cluster, else the cudaError_t of the launch (0 on
// success); the caller raises on anything else than 0.
int fused_navier_stokes_rk4(const float* y0, float* out, long long* sweeps,
                            int batch, int height, int width, int n_steps,
                            int write_trajectory, int cluster_size, int slab,
                            size_t shared_bytes, const uint8_t* dir_mask,
                            const float* dir_vals,
                            const uint8_t* ghost_row_mask,
                            const float* ghost_row_vals,
                            const uint8_t* ghost_col_mask,
                            const float* ghost_col_vals,
                            const float* coefficients, float denominator,
                            double tol, int max_iterations, void* stream) {
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3 ||
      !(cluster_size == 1 || cluster_size == 2 || cluster_size == 4 ||
        cluster_size == 8) ||
      height < cluster_size ||
      slab < (height + cluster_size - 1) / cluster_size ||
      max_iterations < 0 || shared_bytes == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel =
      write_trajectory
          ? reinterpret_cast<const void*>(
                fused_navier_stokes_rk4_kernel<true>)
          : reinterpret_cast<const void*>(
                fused_navier_stokes_rk4_kernel<false>);

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

  const int cells = slab * width;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;

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
