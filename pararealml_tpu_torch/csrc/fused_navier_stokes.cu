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
// Hopper it does not fit one block, so one thread block cluster of 1, 2,
// 4 or 8 blocks holds one state, as the 3D kernel K9 does
// (fused_system_3d.cu). Its blocks split axis 0 into slabs of rows.
//
// Each thread owns a fixed set of up to CELLS cells for the whole solve
// (a template parameter the host's plan names), as K5 does
// (system_2d_resident.cuh): slot s of thread t is cell t + s * blockDim.x
// of its block's list, which holds the slab's rows and the halo rows a
// group's sweeps reach (K - 1 past each slab edge that has a neighbour):
// the interior cells first (the slab's row by row, then the halo's, the
// nearest rows first), then the face cells (the slab's top face, its side
// faces row by row and its bottom face, then the halo's side faces), so
// that all but one warp run the interior path (system_2d.cuh's KnownFaces
// with no face: no bounds test, no face term) and the face cells the full
// helpers. Set up once, with integer divisions there only, the thread
// keeps in registers each cell's index, faces, reach (the sweeps of a
// group that cover its row) and Dirichlet bits in one word, its grid row
// and column, the step's right-hand side -w and the psi its last sweep
// wrote, which is the cell's input of the next sweep. A loop over a
// thread's cells has a compile-time trip count, so the loads of all its
// cells are in flight together. Shared memory holds the three
// stream-function buffers, each the slab plus guard rows, the stage
// inputs (w and a stage buffer, with a guard row of zeros above and
// below), of the slab only u, v and the Dirichlet values, and the Neumann
// face data of w and psi, so that the face cells' warps do not wait on
// device memory. The stages' per-cell data stays in shared memory: in
// registers it made every instance spill (two to five cells a thread at
// 64 or 80 registers; NVIDIA H100 80GB HBM3). A stage reads a neighbour
// across a slab edge from the neighbouring block's shared memory through
// distributed shared memory (mapa and ld.shared::cluster), a flag of the
// cell's word choosing it, and one cluster.sync() closes each stage and
// each step (a stage reads one buffer and writes another: state ->
// stage_a -> stage_b -> stage_a -> stage_b).
//
// The Jacobi sweeps run in groups of K (a template parameter, the plan's
// group) between cluster barriers:
// - Three stream-function buffers, each the slab plus K guard rows above
//   and below it, rotate through the solve as the group's start buffer S
//   and two work buffers: the state's psi, stage_a and the last one, where
//   stage 3 writes D1(psi), the solve's start.
// - At a group's start each block copies, once, the K rows of S next to
//   its slab from each neighbour through distributed shared memory (and,
//   in a step's first group, each halo cell's thread reads its -w from the
//   neighbour's w plane). It then runs the group's sweeps over its slab
//   and a halo that shrinks by one row a sweep (sweep t = 0, ..., K - 1
//   covers the cells whose reach is past t: K - 1 - t rows past each slab
//   edge that has a neighbour), separated by __syncthreads only. A halo
//   cell runs the same operations on the same inputs as the neighbour's
//   own cell, so it is bit for bit equal to it. K is at most the smallest
//   slab's rows, so a halo comes from the adjacent blocks only. Guard rows
//   past the grid's faces hold zeros, which is what the whole-grid helpers
//   read there.
// - Each thread sums the squares of its own-row cells' updates, one sum a
//   sweep, into a shared slot of its own. At the group's end each warp
//   reduces them by shuffles, warp 0 reduces the warps' sums by shuffles
//   in a fixed order, and the block's sum of each sweep goes into its own
//   slot. One cluster barrier closes the group. Then every warp reads the
//   group's slots of every rank through distributed shared memory, one a
//   lane, adds each sweep's in rank order by shuffles and finds by a
//   ballot the first sweep after which the norm is at most tol, so every
//   block takes the same branch; a group runs no more sweeps than
//   max_iterations leaves.
// - Sweeps computed past the stopping sweep are discarded and not counted.
//   The stopping sweep's psi is still in its work buffer when it is one of
//   the group's last two sweeps; otherwise the block replays the group up
//   to it from S, which no sweep writes, on the same cells and buffers.
//   The step's end copies it into the state's psi plane if it is
//   elsewhere.
// Why the order is free of races: within a group every block reads S and
// writes only its own work buffers, so no block overwrites rows that a
// neighbour still copies; S becomes a work buffer in the next group at
// the earliest, after the barrier that ends every block's copy. The slots
// alternate between two sets by group: a block writes a set again only
// after a barrier that every block passes after reading it. A block
// writes its w plane at the step's end only, after the solve's last
// barrier, which every neighbour passes after its first group's reads.
// After a solve's last barrier no block reads another's stream-function
// buffers until the step's end has passed its barrier. Each state counts
// its sweeps into a 64-bit device counter, from which the bound is
// reckoned.
//
// A batch of states is the grid: one cluster per state, each with its
// own sweeps (Parareal's fine ends). The trajectory is stored in the JAX
// package's (..., steps, H, W, 4) layout, a thread writing its cells' four
// values as one 16-byte store; a trajectory of one state may publish its
// count of finished frames after the step-end barrier of every chunk of
// steps, so that the host copies them out while it runs (progress.cuh).
// The host refuses, without launching, a plan whose threads and cells do
// not cover a block's cells and a cluster the card cannot place
// (cudaOccupancyMaxActiveClusters).
//
// What bounds it now (tools/ns_sweep_split.py, the example's plan of 8
// blocks x 544 threads x 3 cells and groups of 4, NVIDIA H100 80GB HBM3):
// of a step's 25.3 us with the stamps on, the cluster barriers take 8.8
// (a stage's 1.2 each, the step end's 0.8 and a group's 0.35 a counted
// sweep), the sweeps' stencil 8.6 (0.92 a counted sweep, from 1.23), the
// stages' arithmetic 2.9 (its slowest warp, which holds the face cells
// and the slab edges' remote reads, 1.8 times the mean).
// Later work: fewer cluster barriers a step, and the stages' slowest warp.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "progress.cuh"
#include "system_2d.cuh"

namespace cg = cooperative_groups;

namespace {

using system2d::Cell;
using system2d::Faces;
using system2d::KnownFaces;
using system2d::Neighbours;
using system2d::Params;
using system2d::WholeGrid;

// an interior cell: its faces known at compile time to be none
using Interior = KnownFaces<WholeGrid, false, false, false, false>;

constexpr int kMaxThreads = 1024;
constexpr int kComponents = 4;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;

// The most threads a block of the instance with `cells` cells a thread
// takes (ops/fused_navier_stokes.py CELLS_INSTANCES): its launch bound,
// which leaves each thread the registers its warps' share of an SM
// partition holds, in steps of eight: 768 for one cell (80 registers),
// 640 for three (96) and 512 for ten (128), the large grids'. More
// threads spilled.
__host__ __device__ constexpr int most_threads(int cells) {
  return cells == 1 ? 768 : cells == 3 ? 640 : 512;
}

// The doubles at the start of shared memory for groups of `group`
// sweeps on `threads` threads: two sets of one slot a sweep, each warp's
// sum of each sweep and each thread's sum of squares of each sweep.
__host__ __device__ constexpr int reduction_doubles(int group, int threads) {
  return 2 * group + kMaxWarps * group + threads * group;
}

// The rows kept above and below a slab: the group's halo, or one row of
// zeros past the grid's faces for a cluster of one block.
__host__ __device__ constexpr int guard_rows(int group, int cluster_size) {
  return cluster_size > 1 ? group : 1;
}

// The components whose Neumann face data the stencils read: w and psi.
constexpr int kFaceComponents = 2;

// A block's shared memory (shared_memory_bytes_2d in
// ops/fused_navier_stokes.py computes the same) on `threads` threads for
// an H x W grid: the reduction's doubles; three float planes of the slab
// and its guard rows (the stream-function buffers); two of the slab and a
// row above and below it (w, stage_b); six of the slab (u, v, and the
// Dirichlet values of the four components); the Neumann face values and
// byte masks of w and psi (system_2d.cuh's layout with two components).
__host__ __device__ constexpr size_t shared_bytes_2d(int slab, int height,
                                                     int width, int group,
                                                     int cluster_size,
                                                     int threads) {
  return 8 * static_cast<size_t>(reduction_doubles(group, threads)) +
         4 * static_cast<size_t>(width) *
             (3 * (slab + 2 * guard_rows(group, cluster_size)) +
              2 * (slab + 2) + 6 * slab) +
         5 * 2 * kFaceComponents * static_cast<size_t>(height + width);
}

// The most cells one block's sweeps cover: its rows and the group's halo
// rows (group - 1 past each slab edge that has a neighbour).
int range_cells(int height, int width, int cluster_size, int group) {
  const int halo = cluster_size > 1 ? group - 1 : 0;
  int most = 0;
  for (int r = 0; r < cluster_size; ++r) {
    const int rows =
        (r + 1) * height / cluster_size - r * height / cluster_size;
    const int halos = (r > 0 ? halo : 0) + (r < cluster_size - 1 ? halo : 0);
    most = std::max(most, (rows + halos) * width);
  }
  return most;
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
  // the word a trajectory of one state publishes its finished frames to,
  // or null, and its chunk of frames less one (progress.cuh)
  int* progress;
  int chunk_mask;
};

// An owned cell's word: its index in a stream-function buffer (from the
// buffer's first guard row), its reach (the sweeps of a group that cover
// its row; 0 for a slot past the block's list), whether it lies in the
// slab's own rows, off every face of the grid, on the slab's first row
// below a neighbour or its last row above one, and its Dirichlet bits, one
// a component.
constexpr unsigned kIndexMask = 0xffffu;
constexpr int kReachShift = 16;
constexpr unsigned kOwnRow = 1u << 20;
constexpr unsigned kInterior = 1u << 21;
constexpr unsigned kRemoteAbove = 1u << 22;
constexpr unsigned kRemoteBelow = 1u << 23;
constexpr int kFixedShift = 24;

__device__ __forceinline__ int index_of(unsigned word) {
  return static_cast<int>(word & kIndexMask);
}

__device__ __forceinline__ int reach_of(unsigned word) {
  return static_cast<int>((word >> kReachShift) & 0xfu);
}

__device__ __forceinline__ bool fixed(unsigned word, int comp) {
  return (word >> (kFixedShift + comp)) & 1u;
}

// A copy of `value` that the compiler cannot hoist out of a loop. A stage
// or a sweep reads each slot's word (and a stage its offsets) through it,
// so that what it derives from them (indices, addresses, flags, a face
// cell's row and column) is computed where it is used: kept for the whole
// solve, those made every instance spill.
__device__ __forceinline__ unsigned opaque(unsigned value) {
  unsigned copy;
  asm volatile("mov.b32 %0, %1;" : "=r"(copy) : "r"(value));
  return copy;
}

__device__ __forceinline__ int opaque(int value) {
  return static_cast<int>(opaque(static_cast<unsigned>(value)));
}

// A face cell's grid row and column from its packed (i << 16) | j.
__device__ __forceinline__ Cell face_cell(unsigned ij) {
  Cell x;
  x.i = static_cast<int>(ij >> 16);
  x.j = static_cast<int>(ij & 0xffffu);
  x.idx = 0;
  return x;
}

// What a thread keeps of its cells for the whole solve, a slot a cell:
// the word, the packed row and column, the step's right-hand side -w and
// the psi of the last sweep that covered it.
template <int CELLS>
struct Owned {
  unsigned word[CELLS];
  unsigned ij[CELLS];
  float rhs[CELLS];
  float psi[CELLS];
};

// The block's planes of the slab that only their own cells read: u, v,
// the RK4 accumulator (the third stream-function buffer, which the stages
// do not otherwise use) and the Dirichlet values, one plane a component.
struct Stage {
  float* u;
  float* v;
  float* acc;
  float* fixed;
  int stride;
  __device__ __forceinline__ float dirichlet(int comp, int lc) const {
    return fixed[comp * stride + lc];
  }
};

// Where a block reads its neighbours' rows of a stage plane through
// distributed shared memory (the ranks are unused at the grid's faces).
struct Edges {
  int prev_rank;
  int next_rank;
  // from an own cell of the slab's first row to the previous block's last
  // row, and from one of its last row to the next block's first row, in a
  // plane of this block
  int above;
  int below;
};

// The value at `address` of this block's shared memory in block `rank`'s,
// through 32-bit shared::cluster addresses. The asm is volatile so that
// the address is mapped where it is read: hoisted out of the step loop,
// each slot's four planes' mapped addresses above and below made every
// instance spill.
__device__ __forceinline__ float remote(const float* address, int rank) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(address));
  unsigned mapped;
  float value;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(mapped)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(value)
               : "r"(mapped)
               : "memory");
  return value;
}

// A stage plane's value at an own-row cell `lc` (its index in the slab)
// and its four neighbours, across a slab edge from the neighbouring
// block's plane; a face cell's neighbours past the grid are set to zero by
// the caller.
__device__ __forceinline__ Neighbours stage_fetch(const float* plane, int lc,
                                                  unsigned word, int width,
                                                  const Edges& edges) {
  Neighbours n;
  n.centre = plane[lc];
  n.above = plane[lc - width];
  if (word & kRemoteAbove) {
    n.above = remote(plane + (lc + edges.above), edges.prev_rank);
  }
  n.below = plane[lc + width];
  if (word & kRemoteBelow) {
    n.below = remote(plane + (lc + edges.below), edges.next_rank);
  }
  n.left = plane[lc - 1];
  n.right = plane[lc + 1];
  return n;
}

// A face cell's left and right neighbours past the grid's side faces read
// as zero, as the whole-grid fetch reads them.
__device__ __forceinline__ void clip_sides(Neighbours& n, const Cell& x,
                                           int width) {
  if (x.j == 0) n.left = 0.0f;
  if (x.j == width - 1) n.right = 0.0f;
}

// The vorticity's right-hand side at one cell of Grid.
template <class Grid>
__device__ __forceinline__ float vorticity_rhs(const Neighbours& n,
                                               const Cell& x,
                                               const Params& p,
                                               const Faces& f, float u,
                                               float v) {
  return (p.coefficient * system2d::laplacian<Grid>(n, 0, x, p, f) -
          u * system2d::gradient_0<Grid>(n, 0, x, p, f)) -
         v * system2d::gradient_1<Grid>(n, 0, x, p, f);
}

// f(w, u, v) at an own-row cell of the thread, the interior path or the
// full helpers by the cell's word.
__device__ __forceinline__ float stage_k(Neighbours n, unsigned word,
                                         unsigned ij, const Params& p,
                                         const Faces& f, float u, float v) {
  if (word & kInterior) return vorticity_rhs<Interior>(n, Cell{}, p, f, u, v);
  const Cell x = face_cell(ij);
  clip_sides(n, x, p.width);
  return vorticity_rhs<WholeGrid>(n, x, p, f, u, v);
}

// The cells a thread loads before it computes any of them: all of its
// cells, so that their loads are in flight together, or half of them for
// the ten-cell instance, whose registers hold no more.
__host__ __device__ constexpr int load_batch(int cells) {
  return cells > 5 ? cells / 2 : cells;
}

// RK4 stage STAGE over the thread's own-row cells: k from `in`, and for
// STAGE 0-2 the accumulator and the next stage's input D0(w + c k), for
// STAGE 3 w' = D0(w + (d_t/6) (acc + k)), into `out` (the slab's rows of
// a stage plane).
template <int STAGE, int CELLS>
__device__ __forceinline__ void rk4_stage(const float* in, float* out,
                                          const float* w,
                                          const Owned<CELLS>& o,
                                          const Stage& st, int row_zero,
                                          const Edges& edges,
                                          const Params& p, const Faces& f) {
  constexpr int kBatch = load_batch(CELLS);
  const int zero = opaque(row_zero);
#pragma unroll
  for (int s0 = 0; s0 < CELLS; s0 += kBatch) {
    Neighbours n[kBatch];
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (word & kOwnRow) {
        n[s - s0] =
            stage_fetch(in, index_of(word) - zero, word, p.width, edges);
      }
    }
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (!(word & kOwnRow)) continue;
      const int lc = index_of(word) - zero;
      float u = st.u[lc];
      float v = st.v[lc];
      if (STAGE > 0) {
        if (fixed(word, 2)) u = st.dirichlet(2, lc);
        if (fixed(word, 3)) v = st.dirichlet(3, lc);
      }
      const float k = stage_k(n[s - s0], word, opaque(o.ij[s]), p, f, u, v);
      float next;
      if constexpr (STAGE == 0) {
        st.acc[lc] = k;
        next = w[lc] + p.half_d_t * k;
      } else if constexpr (STAGE < 3) {
        st.acc[lc] = st.acc[lc] + 2.0f * k;
        next = w[lc] + (STAGE == 1 ? p.half_d_t : p.d_t) * k;
      } else {
        next = w[lc] + p.sixth_d_t * (st.acc[lc] + k);
      }
      out[lc] = fixed(word, 0) ? st.dirichlet(0, lc) : next;
    }
  }
}

// The rest of stage 3 over the thread's own-row cells: the velocities
// from the step-initial psi, D1(psi), the Jacobi solve's start, over the
// accumulator (which stage 3 has read), and the right-hand side -w.
template <int CELLS>
__device__ __forceinline__ void velocities(const float* psi, const float* w,
                                           Owned<CELLS>& o, const Stage& st,
                                           int row_zero, const Edges& edges,
                                           const Params& p, const Faces& f) {
  constexpr int kBatch = load_batch(CELLS);
  const int zero = opaque(row_zero);
#pragma unroll
  for (int s0 = 0; s0 < CELLS; s0 += kBatch) {
    Neighbours n[kBatch];
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (word & kOwnRow) {
        n[s - s0] =
            stage_fetch(psi, index_of(word) - zero, word, p.width, edges);
      }
    }
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (!(word & kOwnRow)) continue;
      const int lc = index_of(word) - zero;
      Neighbours& m = n[s - s0];
      float gradient_1;
      float gradient_0;
      if (word & kInterior) {
        gradient_1 = system2d::gradient_1<Interior>(m, 1, Cell{}, p, f);
        gradient_0 = system2d::gradient_0<Interior>(m, 1, Cell{}, p, f);
      } else {
        const Cell x = face_cell(opaque(o.ij[s]));
        clip_sides(m, x, p.width);
        gradient_1 = system2d::gradient_1<WholeGrid>(m, 1, x, p, f);
        gradient_0 = system2d::gradient_0<WholeGrid>(m, 1, x, p, f);
      }
      st.u[lc] = fixed(word, 2) ? st.dirichlet(2, lc) : gradient_1;
      st.v[lc] = fixed(word, 3) ? st.dirichlet(3, lc) : -gradient_0;
      st.acc[lc] = fixed(word, 1) ? st.dirichlet(1, lc) : m.centre;
      o.rhs[s] = -w[lc];
    }
  }
}

// One Jacobi sweep t of a group from `in` into `out` (stream-function
// buffers, from their first guard row) over the thread's cells whose
// reach is past t, with the Laplacian of the whole-grid helpers at each
// cell's grid coordinates. Returns this thread's sum of squared updates
// over its own-row cells (0 without NORM).
template <bool NORM, int CELLS>
__device__ __forceinline__ double sweep(const float* __restrict__ in,
                                        float* __restrict__ out, int t,
                                        Owned<CELLS>& o, const Params& p,
                                        const Faces& f, float denominator) {
  constexpr int kBatch = load_batch(CELLS);
  const int width = p.width;
  double squares = 0.0;
#pragma unroll
  for (int s0 = 0; s0 < CELLS; s0 += kBatch) {
    Neighbours n[kBatch];
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (reach_of(word) > t) {
        const int e = index_of(word);
        // a cell a sweep covers was covered by the sweep before it, whose
        // output is this sweep's input: its psi is the thread's own
        n[s - s0].centre = t == 0 ? in[e] : o.psi[s];
        n[s - s0].above = in[e - width];
        n[s - s0].below = in[e + width];
        n[s - s0].left = in[e - 1];
        n[s - s0].right = in[e + 1];
      }
    }
#pragma unroll
    for (int s = s0; s < s0 + kBatch; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (reach_of(word) <= t) continue;
      Neighbours& m = n[s - s0];
      float lap;
      if (word & kInterior) {
        lap = system2d::laplacian<Interior>(m, 1, Cell{}, p, f);
      } else {
        const Cell x = face_cell(opaque(o.ij[s]));
        clip_sides(m, x, width);
        lap = system2d::laplacian<WholeGrid>(m, 1, x, p, f);
      }
      const float update = (lap - o.rhs[s]) / denominator;
      // D1: a Dirichlet cell's psi is its Dirichlet value in every buffer
      // a sweep reads (the solve starts from D1(psi), each sweep writes
      // D1's value, and the halo rows are the neighbours'), so it keeps it
      const float next = fixed(word, 1) ? m.centre : m.centre + update;
      out[index_of(word)] = next;
      o.psi[s] = next;
      if (NORM && (word & kOwnRow)) {
        const double change = static_cast<double>(next - m.centre);
        squares += change * change;
      }
    }
  }
  return squares;
}

// Each warp's sums of values[0..N) over its lanes by shuffles, in lane
// 0: the N sums in lockstep, each in the order of one sum alone.
template <int N>
__device__ __forceinline__ void warp_sums(double (&values)[N]) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      values[i] += __shfl_down_sync(0xffffffffu, values[i], offset);
    }
  }
}

// A barrier over every thread of every block of the cluster, which also
// makes each block's shared-memory writes before it visible to the others.
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// One cluster of cluster_size blocks advances state blockIdx.x /
// cluster_size of `y0` ((B, H, W, 4), row-major) by n_steps steps, with
// Jacobi sweeps in groups of K and up to CELLS cells a thread.
// WRITE_TRAJECTORY: out is (B, n_steps, H, W, 4) and receives every step;
// otherwise out is (B, H, W, 4) and receives the end. dir_mask and
// dir_vals are the Dirichlet grids (4, H, W); sweeps[b] receives the
// state's number of Jacobi sweeps over all steps.
template <bool WRITE_TRAJECTORY, int K, int CELLS>
__global__ void __launch_bounds__(most_threads(CELLS), 1)
    fused_navier_stokes_rk4_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Params& p = a.p;
  const int cluster_size = a.cluster_size;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / cluster_size;
  const int width = p.width;

  // this block's rows [row_begin, row_begin + rows) of the grid
  const int row_begin = rank * p.height / cluster_size;
  const int rows = (rank + 1) * p.height / cluster_size - row_begin;
  const int slab_cells = rows * width;
  const int guard = guard_rows(K, cluster_size);
  // the floats of a stream-function buffer (the slab and its guard rows)
  // and of a stage plane (the slab and a row above and below)
  const int guarded = (a.slab + 2 * guard) * width;
  const int padded = (a.slab + 2) * width;
  const int row_zero = guard * width;
  const size_t plane = static_cast<size_t>(p.height) * width;
  const size_t slab_offset = static_cast<size_t>(row_begin) * width;

  // layout (shared_bytes_2d): the reduction's doubles, the three
  // stream-function buffers, w, stage_b, the stage's planes, the faces
  extern __shared__ __align__(16) double shared[];
  double* partials = shared;
  double* warp_partials = shared + 2 * K;
  double* thread_squares = warp_partials + kMaxWarps * K;
  float* psi_buffers = reinterpret_cast<float*>(
      shared + reduction_doubles(K, static_cast<int>(blockDim.x)));
  float* w_padded = psi_buffers + 3 * guarded;
  float* stage_b_padded = w_padded + padded;
  // each plane from its slab's first row; the state's psi and stage_a
  // are the first two stream-function buffers, and stage 3 writes the
  // Jacobi solve's start D1(psi) into the third
  float* const psi = psi_buffers + row_zero;
  float* const stage_a = psi_buffers + guarded + row_zero;
  float* const start_psi = psi_buffers + 2 * guarded + row_zero;
  float* const w = w_padded + width;
  float* const stage_b = stage_b_padded + width;

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  // the guard rows read as zero where no slab or halo fills them
  for (int e = tid; e < 3 * guarded + 2 * padded; e += threads) {
    psi_buffers[e] = 0.0f;
  }
  __syncthreads();

  const bool has_prev = rank > 0;
  const bool has_next = rank < cluster_size - 1;
  // the thread's cells (a division for each, here only): the block's list
  // holds the slab's interior cells row by row, the halo rows' interior
  // cells (the nearest rows first, the upper before the lower), the slab's
  // top face, its side faces row by row, its bottom face, and the halo
  // rows' side faces in the halo's order
  const int halo_up = has_prev ? K - 1 : 0;
  const int halo_down = has_next ? K - 1 : 0;
  const int halo_sides = (halo_up > 0) + (halo_down > 0);
  const int inner = width - 2;
  const int inner_lo = max(row_begin, 1) - row_begin;
  const int inner_rows =
      max(min(row_begin + rows, p.height - 1) - row_begin - inner_lo, 0);
  const int n_slab_inner = inner_rows * inner;
  const int n_inner = n_slab_inner + (halo_up + halo_down) * inner;
  const int top = row_begin == 0 ? width : 0;
  const int sides = 2 * inner_rows;
  const int bottom = row_begin + rows == p.height ? width : 0;
  const int n_cells = (rows + halo_up + halo_down) * width;
  // halo row h of the list's order, as a row of the slab's numbering
  auto halo_row = [&](int h) {
    const int d = 1 + h / max(halo_sides, 1);
    const bool upper = halo_sides == 2 ? (h & 1) == 0 : halo_up > 0;
    return upper ? -d : rows - 1 + d;
  };
  const float4* y_in = reinterpret_cast<const float4*>(a.y0) + b * plane;
  Owned<CELLS> o;
  Stage st;
  st.stride = a.slab * width;
  st.u = stage_b_padded + padded;
  st.v = st.u + st.stride;
  st.fixed = st.v + st.stride;
  st.acc = start_psi;
  // the Neumann faces of w and psi: (2 faces, 2 components, length) of
  // the host's (2 faces, 4 components, length)
  Faces f;
  f.n = kFaceComponents;
  f.inv_r = nullptr;
  {
    float* grv = st.fixed + kComponents * st.stride;
    float* gcv = grv + 2 * kFaceComponents * width;
    uint8_t* grm =
        reinterpret_cast<uint8_t*>(gcv + 2 * kFaceComponents * p.height);
    uint8_t* gcm = grm + 2 * kFaceComponents * width;
    for (int e = tid; e < 2 * kFaceComponents * width; e += threads) {
      const int segment = e / width;
      const int source = ((segment >> 1) * kComponents + (segment & 1)) *
                             width + e - segment * width;
      grv[e] = a.faces.grv[source];
      grm[e] = a.faces.grm[source];
    }
    for (int e = tid; e < 2 * kFaceComponents * p.height; e += threads) {
      const int segment = e / p.height;
      const int source = ((segment >> 1) * kComponents + (segment & 1)) *
                             p.height + e - segment * p.height;
      gcv[e] = a.faces.gcv[source];
      gcm[e] = a.faces.gcm[source];
    }
    f.grv = grv;
    f.grm = grm;
    f.gcv = gcv;
    f.gcm = gcm;
  }
#pragma unroll
  for (int s = 0; s < CELLS; ++s) {
    const int q = tid + s * threads;
    int lr = 0;
    int j = 0;
    if (q < n_slab_inner) {
      lr = inner_lo + q / inner;
      j = 1 + q % inner;
    } else if (q < n_inner) {
      const int r = q - n_slab_inner;
      lr = halo_row(r / inner);
      j = 1 + r % inner;
    } else if (q < n_cells) {
      int r = q - n_inner;
      if (r < top) {
        j = r;
      } else if ((r -= top) < sides) {
        lr = inner_lo + r / 2;
        j = (r & 1) ? width - 1 : 0;
      } else if ((r -= sides) < bottom) {
        lr = rows - 1;
        j = r;
      } else {
        r -= bottom;
        lr = halo_row(r / 2);
        j = (r & 1) ? width - 1 : 0;
      }
    }
    const bool valid = q < n_cells;
    const bool own = valid && lr >= 0 && lr < rows;
    const int reach =
        !valid ? 0 : own ? K : K - (lr < 0 ? -lr : lr - rows + 1);
    unsigned word = static_cast<unsigned>(row_zero + lr * width + j) |
                    (static_cast<unsigned>(reach) << kReachShift);
    if (own) word |= kOwnRow;
    if (q < n_inner) word |= kInterior;
    if (own && lr == 0 && has_prev) word |= kRemoteAbove;
    if (own && lr == rows - 1 && has_next) word |= kRemoteBelow;
    const int i = row_begin + lr;
    const size_t cell = static_cast<size_t>(i) * width + j;
    o.ij[s] = (static_cast<unsigned>(i) << 16) | static_cast<unsigned>(j);
    o.rhs[s] = 0.0f;
    o.psi[s] = 0.0f;
    if (valid && a.dir_mask[plane + cell]) word |= 1u << (kFixedShift + 1);
    const int lc = lr * width + j;
    if (own) {
      // the state arrives interleaved ((H, W, 4)) and is kept as planes
      const float4 y = y_in[cell];
      w[lc] = y.x;
      psi[lc] = y.y;
      st.u[lc] = y.z;
      st.v[lc] = y.w;
      // the Dirichlet data of the four components
#pragma unroll
      for (int comp = 0; comp < kComponents; ++comp) {
        const size_t e = comp * plane + cell;
        if (a.dir_mask[e]) word |= 1u << (kFixedShift + comp);
        st.fixed[comp * st.stride + lc] = a.dir_vals[e];
      }
    }
    o.word[s] = word;
  }
  // every block of the cluster has started and loaded its slab before any
  // reads a neighbour's shared memory
  cluster_barrier();

  const int prev_rows =
      has_prev ? row_begin - (rank - 1) * p.height / cluster_size : 0;
  Edges edges;
  edges.prev_rank = rank - 1;
  edges.next_rank = rank + 1;
  edges.above = (prev_rows - 1) * width;
  edges.below = -(rows - 1) * width;
  auto buffer = [&](int index) { return psi_buffers + index * guarded; };
  long long total_sweeps = 0;
  int set = 0;

  NS_SPLIT_BEGIN
  for (int step = 0; step < a.n_steps; ++step) {
    // stage 0: k1 from the state's w, u and v
    rk4_stage<0>(w, stage_a, w, o, st, row_zero, edges, p, f);
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    // stages 1 and 2, with the velocities' Dirichlet values
    rk4_stage<1>(stage_a, stage_b, w, o, st, row_zero, edges, p, f);
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    rk4_stage<2>(stage_b, stage_a, w, o, st, row_zero, edges, p, f);
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);
    // stage 3: w' into stage_b (w stays the solve's right-hand side), then
    // the velocities from the step-initial psi (no block reads u and v
    // across cells), D1(psi) over the accumulator and the own-row cells'
    // -w
    rk4_stage<3>(stage_a, stage_b, w, o, st, row_zero, edges, p, f);
    velocities(psi, w, o, st, row_zero, edges, p, f);
    NS_SPLIT_MARK(0);
    cluster_barrier();
    NS_SPLIT_MARK(1);

    // the Jacobi solve of lap(psi') = -w, from buffer 2
    int start = 2;
    int result = 2;
    int iterations = 0;
    bool first_group = true;
    while (iterations < a.max_iterations) {
      const int group = min(K, a.max_iterations - iterations);
      float* const s_buffer = buffer(start);
      float* const work_0 = buffer((start + 1) % 3);
      float* const work_1 = buffer((start + 2) % 3);
      // the halo: the neighbours' K rows of S next to the slab (and, in
      // the step's first group, each halo cell's -w)
      if (cluster_size > 1) {
        const int halo = K * width;
        const float* prev_s =
            has_prev ? cluster.map_shared_rank(s_buffer, rank - 1) +
                           (guard + prev_rows - K) * width
                     : nullptr;
        const float* next_s =
            has_next ? cluster.map_shared_rank(s_buffer, rank + 1) + row_zero
                     : nullptr;
        float* const upper_s = s_buffer + row_zero - halo;
        float* const lower_s = s_buffer + row_zero + slab_cells;
        for (int e = tid; e < halo; e += threads) {
          if (has_prev) upper_s[e] = prev_s[e];
          if (has_next) lower_s[e] = next_s[e];
        }
        if (first_group) {
          // the previous block's rows end at its row prev_rows, the next
          // block's begin at this block's row `rows`
#pragma unroll
          for (int s = 0; s < CELLS; ++s) {
            const unsigned word = opaque(o.word[s]);
            if ((word & kOwnRow) || reach_of(word) == 0) continue;
            const int lc = index_of(word) - row_zero;
            o.rhs[s] =
                -(lc < 0 ? remote(w + (lc + prev_rows * width), rank - 1)
                         : remote(w + (lc - slab_cells), rank + 1));
          }
        }
        __syncthreads();
      }
      first_group = false;
      NS_SPLIT_MARK(2);
      // the group's sweeps, each thread's sum of squares of each into its
      // own shared slot
      for (int t = 0; t < group; ++t) {
        if (t > 0) __syncthreads();
        thread_squares[t * threads + tid] = sweep<true>(
            t == 0 ? s_buffer : (t & 1) ? work_0 : work_1,
            (t & 1) ? work_1 : work_0, t, o, p, f, a.denominator);
      }
      NS_SPLIT_MARK(3);
      NS_SPLIT_COUNT(0, group);
      // the block's sum of each sweep: each warp's by shuffles, then warp
      // 0's over the warps' sums by shuffles, into this group's slots
      // (four sweeps at a time, whose sums fit the registers)
      constexpr int kChunk = K < 4 ? K : 4;
#pragma unroll
      for (int t0 = 0; t0 < K; t0 += kChunk) {
        double sums[kChunk];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          sums[t] = t0 + t < group ? thread_squares[(t0 + t) * threads + tid]
                                   : 0.0;
        }
        warp_sums(sums);
        if (lane == 0) {
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            warp_partials[(t0 + t) * kMaxWarps + warp] = sums[t];
          }
        }
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int t0 = 0; t0 < K; t0 += kChunk) {
          double sums[kChunk];
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            sums[t] = lane < warps
                          ? warp_partials[(t0 + t) * kMaxWarps + lane]
                          : 0.0;
          }
          warp_sums(sums);
          if (lane == 0) {
#pragma unroll
            for (int t = 0; t < kChunk; ++t) {
              partials[set * K + t0 + t] = sums[t];
            }
          }
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
          sweep<false>(t == 0 ? s_buffer : (t & 1) ? work_0 : work_1,
                       (t & 1) ? work_1 : work_0, t, o, p, f, a.denominator);
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
    const int zero = opaque(row_zero);
    const float* const solved = buffer(result) + row_zero;
    float4* frame =
        WRITE_TRAJECTORY
            ? reinterpret_cast<float4*>(a.out) +
                  (b * a.n_steps + step) * plane + slab_offset
            : nullptr;
#pragma unroll
    for (int s = 0; s < CELLS; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (!(word & kOwnRow)) continue;
      const int lc = index_of(word) - zero;
      const float w_next = stage_b[lc];
      w[lc] = w_next;
      const float psi_next = solved[lc];
      if (result != 0) psi[lc] = psi_next;
      if constexpr (WRITE_TRAJECTORY) {
        frame[lc] = make_float4(w_next, psi_next, st.u[lc], st.v[lc]);
      }
    }
    NS_SPLIT_MARK(8);
    cluster_barrier();
    NS_SPLIT_MARK(9);
    if (WRITE_TRAJECTORY && a.progress != nullptr && rank == 0 && tid == 0) {
      frame_progress::publish_frames(a.progress, a.chunk_mask, step,
                                     a.n_steps);
    }
  }
  NS_SPLIT_END
  // the loop ends on a cluster barrier: no neighbour reads this block's
  // shared memory any more, so the block may write its end state and exit
  if (!WRITE_TRAJECTORY) {
    float4* y_out = reinterpret_cast<float4*>(a.out) + b * plane + slab_offset;
#pragma unroll
    for (int s = 0; s < CELLS; ++s) {
      const unsigned word = opaque(o.word[s]);
      if (!(word & kOwnRow)) continue;
      const int lc = index_of(word) - row_zero;
      y_out[lc] = make_float4(w[lc], psi[lc], st.u[lc], st.v[lc]);
    }
  }
  if (rank == 0 && tid == 0) a.sweeps[b] = total_sweeps;
}

template <int K, int CELLS>
const void* select_output(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   fused_navier_stokes_rk4_kernel<true, K, CELLS>)
             : reinterpret_cast<const void*>(
                   fused_navier_stokes_rk4_kernel<false, K, CELLS>);
}

template <int K>
const void* select_cells(int cells, int write_trajectory) {
  switch (cells) {
    case 1:
      return select_output<K, 1>(write_trajectory);
    case 3:
      return select_output<K, 3>(write_trajectory);
    case 10:
      return select_output<K, 10>(write_trajectory);
    default:
      return nullptr;
  }
}

// The kernel instance for groups of `group` sweeps (1, 2, 3, 4 or 8) and
// `cells` cells a thread (1, 3 or 10), or nullptr.
const void* select_kernel(int group, int cells, int write_trajectory) {
  switch (group) {
    case 1:
      return select_cells<1>(cells, write_trajectory);
    case 2:
      return select_cells<2>(cells, write_trajectory);
    case 3:
      return select_cells<3>(cells, write_trajectory);
    case 4:
      return select_cells<4>(cells, write_trajectory);
    case 8:
      return select_cells<8>(cells, write_trajectory);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

const char* fused_navier_stokes_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// The registers a thread, local-memory bytes (spills) a thread and most
// threads a block of the instance for groups of `group` sweeps and
// `cells` cells a thread, as the card reports them (ptxas's counts): the
// larger counts and the fewer threads of its trajectory and end kernels.
// Returns the cudaError_t (cudaErrorInvalidValue for an instance that was
// not built).
int fused_navier_stokes_instance_attributes(int group, int cells,
                                            int* registers, int* local_bytes,
                                            int* max_threads) {
  *registers = 0;
  *local_bytes = 0;
  *max_threads = kMaxThreads;
  for (int write_trajectory = 0; write_trajectory < 2; ++write_trajectory) {
    const void* kernel = select_kernel(group, cells, write_trajectory);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes attributes;
    cudaError_t error = cudaFuncGetAttributes(&attributes, kernel);
    if (error != cudaSuccess) return static_cast<int>(error);
    *registers = std::max(*registers, attributes.numRegs);
    *local_bytes =
        std::max(*local_bytes, static_cast<int>(attributes.localSizeBytes));
    *max_threads = std::min(*max_threads, attributes.maxThreadsPerBlock);
  }
  return 0;
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
// holds) with `cells` cells a thread (1, 3 or 10; threads and cells must
// cover the most cells a block's sweeps reach, and the threads be at most
// the instance's most_threads). Each block holds a slab of at most `slab`
// rows in `shared_bytes` of dynamic shared memory, as the caller's cluster
// plan sizes them (shared_memory_bytes_2d in ops/fused_navier_stokes.py,
// which must equal shared_bytes_2d). coefficients are the 15 of
// system2d::make_params (d_t / 2, d_t, d_t / 6, 1 / Re, four unused, ...);
// denominator is 2 / dx0^2 + 2 / dx1^2; each step's Jacobi solve stops
// once its update norm is at most tol or after max_iterations sweeps.
// sweeps ((batch,) int64) receives each state's total sweeps. Returns
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorCooperativeLaunchTooLarge, without launching, when the card
// cannot place one such cluster, else the cudaError_t of the launch (0 on
// success); the caller raises on anything else than 0. A trajectory of one
// state with a non-null `progress` stores its count of finished frames
// there after every `chunk` steps (a power of two) and after the last
// (progress.cuh); a launch that progress.cuh does not admit is refused.
int fused_navier_stokes_rk4(const float* y0, float* out, long long* sweeps,
                            int batch, int height, int width, int n_steps,
                            int write_trajectory, int cluster_size, int slab,
                            int group, int threads, int cells,
                            size_t shared_bytes, const uint8_t* dir_mask,
                            const float* dir_vals,
                            const uint8_t* ghost_row_mask,
                            const float* ghost_row_vals,
                            const uint8_t* ghost_col_mask,
                            const float* ghost_col_vals,
                            const float* coefficients, float denominator,
                            double tol, int max_iterations, int* progress,
                            int chunk, void* stream) {
  const void* kernel = select_kernel(group, cells, write_trajectory);
  if (kernel == nullptr || batch <= 0 || n_steps <= 0 || height < 3 ||
      !frame_progress::publication_valid(progress, chunk, batch,
                                         write_trajectory) ||
      width < 3 ||
      !(cluster_size == 1 || cluster_size == 2 || cluster_size == 4 ||
        cluster_size == 8) ||
      height < cluster_size ||
      slab < (height + cluster_size - 1) / cluster_size ||
      (cluster_size > 1 && group > height / cluster_size) || threads < 32 ||
      threads > most_threads(cells) || threads % 32 != 0 ||
      max_iterations < 0 ||
      static_cast<long long>(threads) * cells <
          range_cells(height, width, cluster_size, group) ||
      static_cast<long long>(slab + 2 * guard_rows(group, cluster_size)) *
              width >
          static_cast<long long>(kIndexMask) + 1 ||
      shared_bytes != shared_bytes_2d(slab, height, width, group,
                                      cluster_size, threads)) {
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
  a.progress = progress;
  a.chunk_mask = progress == nullptr ? 0 : chunk - 1;

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
