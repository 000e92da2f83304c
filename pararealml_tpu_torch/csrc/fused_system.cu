// Fused RK4 kernels for multi-component 2D systems on Cartesian and polar
// meshes with static boundary conditions whose grid fits one thread block,
// for Hopper (sm_90a): wave, Burgers, shallow water and Cahn-Hilliard.
//
// Replaces the JAX package's Pallas TPU kernels:
//   ops/fused_system.py  K5 build_fused_system_rk4_trajectory (every step
//                           stored), build_fused_system_rk4_end (end state,
//                           single or batched), build_fused_system_rk4_step
//                           (one step: the trajectory with n_steps = 1);
//   ops/packed_system.py K4 build_packed_system_rk4_ends and
//                           build_packed_system_rk4_trajectory (B Parareal
//                           slices advanced together).
// All of them are launches of one kernel template, templated on an
// equation functor of system_2d.cuh (shared with the tiled kernel K8), on
// the grid (Cartesian, or polar with the per-row 1 / r metric terms of the
// JAX package's polar branch; K4 is Cartesian only, as in the JAX package),
// on the cells each thread owns and on whether every step is stored. It
// computes what the JAX package's step factories compute over its
// _StencilHelpers, term for term and in the same order. For the wave,
// Burgers and shallow-water systems, classic RK4:
//   k1 = f(y), k2 = f(D(y + (d_t/2) k1)), k3 = f(D(y + (d_t/2) k2)),
//   k4 = f(D(y + d_t k3)), y' = D(y + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
// with D the per-component Dirichlet override; for Cahn-Hilliard its own
// two-stage step (system_2d.cuh). The Laplacian adds each axis's Neumann
// ghost term to that axis's second derivative before summing them.
//
// What bounds it on the card: neither bytes nor FLOPs. The main paths'
// grids are 21 x 21 x 2 to 41 x 41 x 2 and 36 x 51 x 3 (3.5 to 22 KB of
// state) and one RK4 step is 35 to 323 FLOPs a cell, so each step is a
// chain of dependent stages on one SM. The step split of the first
// design, one CTA with every buffer in shared memory
// (tools/k5_step_split.py, NVIDIA H100 80GB HBM3 at 700 W), put 99% of a
// step in the stages' arithmetic and 14-34 cycles in each barrier: a
// Burgers stage over 21 x 21 took about 2,450 cycles for one cell a
// thread, a polar shallow-water stage over 36 x 51 about 7,300.
//
// What the design does about it. One CTA owns one state for all n_steps
// (or, where the caller asks for it, a thread block cluster splits the
// rows of a state, each block pushing its edge rows into its neighbours'
// halo rows through distributed shared memory). Each thread owns a fixed
// set of up to CELLS cells for the whole solve, the interior cells first
// and the cells on the grid's faces after them, so that all but one warp
// take one path: an interior cell runs the functors on system_2d.cuh's
// Interior grid (no bounds test, no face term), a face cell the full
// helpers. The thread keeps its cells' coordinates and flags, Dirichlet
// masks and values, state and RK4 accumulator in registers; shared memory
// holds only what neighbours read, the stage input, ping-ponged between
// two sets of n planes (padded by one halo row above and below), with one
// barrier a stage, and the Neumann face vectors and 1 / r. No integer
// division runs in the step loop. Device-memory traffic is the initial
// read plus either every step's frame (trajectory; in the JAX package's
// (..., H, W, n) layout, in float32 or, for K4's snapshot dtype, rounded
// to bfloat16 over the float32 carried state) or the end state. A batch of
// states is the grid: one CTA (or cluster) per state, so K4's 100
// Parareal slices run side by side on 100 of the 132 SMs. The TPU
// kernels' (8, 128) padding, lane packing of the slices and DMA
// double-buffering are not carried over. The host admits a grid while the
// first design's working set (ops/fused_system.py shared_memory_bytes)
// fits the 227 KB a block can opt into: about 74 x 74 for two
// components, 60 x 60 for three. Larger grids take K8.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "state_io.cuh"
#include "system_2d.cuh"

namespace cg = cooperative_groups;

// The step split (tools/k5_step_split.py builds this source with
// -DK5_STEP_SPLIT): lane 0 of every warp of block 0 sums the clock64()
// cycles it spends in each segment of the solve (the load, each stage's
// arithmetic, each barrier, the final store) and writes the sums to the
// buffer fused_system_split_buffer points it to, kSplitSegments a warp.
// Without the macro the marks compile to nothing.
constexpr int kSplitSegments = 10;
#ifdef K5_STEP_SPLIT
__device__ long long* k5_split_sums;
#define K5_SPLIT_BEGIN                      \
  long long split_sum[kSplitSegments] = {}; \
  long long split_time = clock64();
#define K5_SPLIT_MARK(segment)                    \
  do {                                            \
    const long long split_now = clock64();        \
    split_sum[segment] += split_now - split_time; \
    split_time = split_now;                       \
  } while (0)
#define K5_SPLIT_END                                           \
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 &&            \
      k5_split_sums != nullptr) {                              \
    for (int s = 0; s < kSplitSegments; ++s) {                 \
      k5_split_sums[(threadIdx.x / 32) * kSplitSegments + s] = \
          split_sum[s];                                        \
    }                                                          \
  }
#else
#define K5_SPLIT_BEGIN
#define K5_SPLIT_MARK(segment)
#define K5_SPLIT_END
#endif

namespace {

using namespace state_io;
using namespace system2d;

constexpr int kMaxThreads = 1024;

// The kernel's arguments: the state and its output, the Dirichlet grids
// (n, H, W) in device memory, the Neumann face vectors of system_2d.cuh
// and, on a polar grid, the H values of 1 / r; the blocks of a cluster
// split the rows into slabs of slab_rows (the last may hold fewer).
struct Args {
  Params p;
  const float* y0;
  void* out;
  int n_steps;
  int frame_bfloat16;
  const uint8_t* dir_mask;
  const float* dir_vals;
  const uint8_t* grm;
  const float* grv;
  const uint8_t* gcm;
  const float* gcv;
  const float* inv_r;
  int cluster_size;
  int slab_rows;
};

// One cell a thread owns: its global row and column and its index in the
// block's padded planes (Cell), its index in the grid, whether it lies off
// every face of the grid, its Dirichlet mask (a bit a component) and
// values, its state and its RK4 accumulator (Cahn-Hilliard: k1 and
// D1(potential)).
template <int N>
struct Slot {
  Cell x;
  int cell;
  bool valid;
  bool interior;
  unsigned fixed;
  float dv[N];
  float y[N];
  float acc[N];
};

// Where a stage's output goes: the block's own planes and, on a cluster,
// the same planes of the blocks above and below (null at the ends), whose
// halo rows receive this block's first and last rows.
struct Target {
  float* local;
  float* prev;
  float* next;
  int stride;
  int width;
  int first_row;
  int last_row;
  // the row of the block above's padded planes below its last own row
  int prev_halo;
};

__device__ __forceinline__ void put(const Target& t, int comp,
                                    const Cell& x, float value) {
  const int plane = comp * t.stride;
  t.local[plane + x.idx] = value;
  if (t.prev != nullptr && x.i == t.first_row) {
    t.prev[plane + t.prev_halo * t.width + x.j] = value;
  }
  if (t.next != nullptr && x.i == t.last_row) {
    t.next[plane + x.j] = value;
  }
}

// A barrier over the block, or over every block of the cluster (which
// also makes the halo rows pushed before it visible).
__device__ __forceinline__ void barrier(int cluster_size) {
  if (cluster_size > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Calls body(G{}) with G the grid type of a cell: for an interior cell
// Grid with its faces known at compile time to be none (system_2d.cuh
// KnownFaces: no bounds test, no face term), else Grid itself, which
// tests them. Two copies of the functors and no more: a copy for each of
// the five kinds of face cell, each kind in warps of its own, made K5's
// step on the 21 x 21 Burgers problem 21% slower, and the same warps with
// these two copies 15% slower (NVIDIA H100 80GB HBM3 at 700 W).
template <class Grid, class Body>
__device__ __forceinline__ void by_cell(bool interior, Body&& body) {
  if (interior) {
    body(KnownFaces<Grid, false, false, false, false>{});
  } else {
    body(Grid{});
  }
}

// Stage STAGE (0-3) of an RK4 step over the thread's cells, reading `in`
// and writing `next` (STAGE < 3: the next stage's input; STAGE == 3: the
// new state, also stored as the step's frame at frame_offset).
template <class Equation, class Grid, int STAGE, int CELLS,
          bool WRITE_TRAJECTORY>
__device__ __forceinline__ void rk4_stage(
    Slot<Equation::kComponents> (&slots)[CELLS], const Planes& in,
    const Target& next, const Params& p, const Faces& f, const Args& a,
    size_t frame_offset) {
  constexpr int N = Equation::kComponents;
#pragma unroll
  for (int s = 0; s < CELLS; ++s) {
    Slot<N>& sl = slots[s];
    if (!sl.valid) continue;
    float k[N];
    by_cell<Grid>(sl.interior, [&](auto grid) {
      Equation::template rhs<decltype(grid)>(in, sl.x, p, f, k);
    });
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      const bool fixed = (sl.fixed >> comp) & 1u;
      if constexpr (STAGE == 0) {
        sl.acc[comp] = k[comp];
        put(next, comp, sl.x,
            fixed ? sl.dv[comp] : sl.y[comp] + p.half_d_t * k[comp]);
      } else if constexpr (STAGE == 1) {
        sl.acc[comp] = sl.acc[comp] + 2.0f * k[comp];
        put(next, comp, sl.x,
            fixed ? sl.dv[comp] : sl.y[comp] + p.half_d_t * k[comp]);
      } else if constexpr (STAGE == 2) {
        sl.acc[comp] = sl.acc[comp] + 2.0f * k[comp];
        put(next, comp, sl.x,
            fixed ? sl.dv[comp] : sl.y[comp] + p.d_t * k[comp]);
      } else {
        const float value =
            fixed ? sl.dv[comp]
                  : sl.y[comp] + p.sixth_d_t * (sl.acc[comp] + k[comp]);
        sl.y[comp] = value;
        put(next, comp, sl.x, value);
        if constexpr (WRITE_TRAJECTORY) {
          store_state(a.out, a.frame_bfloat16,
                      frame_offset + static_cast<size_t>(sl.cell) * N + comp,
                      value);
        }
      }
    }
  }
}

// The first Cahn-Hilliard stage: k1 and the new potential from the state
// in `in`; D1(y1) into component 1 of `next`.
template <class Grid, int CELLS>
__device__ __forceinline__ void cahn_hilliard_first(
    Slot<CahnHilliard2D::kComponents> (&slots)[CELLS], const Planes& in,
    const Target& next, const Params& p, const Faces& f) {
#pragma unroll
  for (int s = 0; s < CELLS; ++s) {
    Slot<2>& sl = slots[s];
    if (!sl.valid) continue;
    float k1, potential;
    by_cell<Grid>(sl.interior, [&](auto grid) {
      CahnHilliard2D::first<decltype(grid)>(in, sl.x, p, f, &k1,
                                            &potential);
    });
    const bool fixed1 = (sl.fixed >> 1) & 1u;
    sl.acc[0] = k1;
    sl.acc[1] = fixed1 ? sl.dv[1] : potential;
    put(next, 1, sl.x, fixed1 ? sl.dv[1] : sl.y[1]);
  }
}

// The second Cahn-Hilliard stage: d lap(D1(y1)) from component 1 of `in`,
// the new state into `next` and the step's frame.
template <class Grid, int CELLS, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void cahn_hilliard_second(
    Slot<CahnHilliard2D::kComponents> (&slots)[CELLS], const Planes& in,
    const Target& next, const Params& p, const Faces& f, const Args& a,
    size_t frame_offset) {
#pragma unroll
  for (int s = 0; s < CELLS; ++s) {
    Slot<2>& sl = slots[s];
    if (!sl.valid) continue;
    float rest;
    by_cell<Grid>(sl.interior, [&](auto grid) {
      rest = CahnHilliard2D::k_rest<decltype(grid)>(in, sl.x, p, f);
    });
    const float combined = sl.acc[0] + 5.0f * rest;
    const float y0 = (sl.fixed & 1u) ? sl.dv[0]
                                     : sl.y[0] + p.sixth_d_t * combined;
    const float y1 = sl.acc[1];
    sl.y[0] = y0;
    sl.y[1] = y1;
    put(next, 0, sl.x, y0);
    put(next, 1, sl.x, y1);
    if constexpr (WRITE_TRAJECTORY) {
      const size_t cell = frame_offset + static_cast<size_t>(sl.cell) * 2;
      store_state(a.out, a.frame_bfloat16, cell, y0);
      store_state(a.out, a.frame_bfloat16, cell + 1, y1);
    }
  }
}

// One CTA (or cluster) advances state blockIdx.x / cluster_size of `y0`
// ((B, H, W, n), row-major) by n_steps steps. WRITE_TRAJECTORY: out is
// (B, n_steps, H, W, n), float32 or bfloat16 (frame_bfloat16), and
// receives every step; otherwise out is (B, H, W, n) float32 and receives
// the end. Each thread owns up to CELLS cells of its block's rows: slot s
// of thread t is cell t + s * blockDim.x of the block's list, its interior
// cells row by row, then its cells on the grid's top face, its side
// faces' cells row by row, and its cells on the bottom face. One block a
// multiprocessor is asked for, of at most MAX_THREADS threads: a state is
// one block (or cluster) and the batches are at most a few hundred
// states, so a second block a multiprocessor buys nothing, and the cap
// leaves 128 registers a thread to blocks of up to 512 threads (64 at
// 1,024, where ptxas spills some instances).
template <class Equation, class Grid, int CELLS, int MAX_THREADS,
          bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    fused_system_rk4_kernel(const Args a) {
  constexpr int N = Equation::kComponents;
  extern __shared__ __align__(16) float shared[];
  K5_SPLIT_BEGIN
  const Params& p = a.p;
  const int h = p.height;
  const int w = p.width;
  const int cluster_size = a.cluster_size;
  const int rank =
      cluster_size > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                       : 0;
  const size_t b = blockIdx.x / cluster_size;
  const int r0 = rank * a.slab_rows;
  const int r1 = min(h, r0 + a.slab_rows);
  // the block's planes: its rows and one halo row above and below
  const int stride = (a.slab_rows + 2) * w;
  // layout (shared_bytes_of): two sets of n float planes, the
  // float face vectors, 1 / r by row on a polar grid, the byte masks
  float* buffer_a = shared;
  float* buffer_b = buffer_a + N * stride;
  float* grv = buffer_b + N * stride;
  float* gcv = grv + 2 * N * w;
  float* inv_r = gcv + 2 * N * h;
  uint8_t* grm = reinterpret_cast<uint8_t*>(inv_r + (Grid::kPolar ? h : 0));
  uint8_t* gcm = grm + 2 * N * w;

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  for (int e = tid; e < 2 * N * w; e += threads) {
    grv[e] = a.grv[e];
    grm[e] = a.grm[e];
  }
  for (int e = tid; e < 2 * N * h; e += threads) {
    gcv[e] = a.gcv[e];
    gcm[e] = a.gcm[e];
  }
  if constexpr (Grid::kPolar) {
    for (int e = tid; e < h; e += threads) inv_r[e] = a.inv_r[e];
  }
  // the state's rows r0 - 1 .. r1 (those inside the grid) arrive
  // interleaved ((H, W, n)) and are kept as planes
  const size_t plane_cells = static_cast<size_t>(h) * w;
  const float* y_in = a.y0 + b * plane_cells * N;
  const int load_lo = max(r0 - 1, 0);
  const int load_hi = min(r1 + 1, h);
  const int load_values = (load_hi - load_lo) * w * N;
  for (int e = tid; e < load_values; e += threads) {
    const int cell = e / N;
    const int comp = e - cell * N;
    const int row = cell / w;
    buffer_a[comp * stride + (load_lo + row - r0 + 1) * w + cell - row * w] =
        y_in[static_cast<size_t>(load_lo) * w * N + e];
  }

  // the thread's cells (a division for each, here only)
  const int inner_lo = max(r0, 1);
  const int inner_rows = max(min(r1, h - 1) - inner_lo, 0);
  const int n_interior = inner_rows * (w - 2);
  const int top = r0 == 0 ? w : 0;
  const int sides = 2 * inner_rows;
  const int n_cells = (r1 - r0) * w;
  Slot<N> slots[CELLS];
#pragma unroll
  for (int s = 0; s < CELLS; ++s) {
    Slot<N>& sl = slots[s];
    const int k = tid + s * threads;
    sl.valid = k < n_cells;
    sl.interior = k < n_interior;
    int i = r0;
    int j = 0;
    if (sl.interior) {
      i = inner_lo + k / (w - 2);
      j = 1 + k % (w - 2);
    } else if (sl.valid) {
      int q = k - n_interior;
      if (q < top) {
        i = 0;
        j = q;
      } else if ((q -= top) < sides) {
        i = inner_lo + q / 2;
        j = (q & 1) ? w - 1 : 0;
      } else {
        i = h - 1;
        j = q - sides;
      }
    }
    sl.x.i = i;
    sl.x.j = j;
    sl.x.idx = (i - r0 + 1) * w + j;
    sl.cell = i * w + j;
    sl.fixed = 0u;
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      sl.y[comp] = 0.0f;
      sl.acc[comp] = 0.0f;
      sl.dv[comp] = 0.0f;
      if (sl.valid) {
        const size_t e = comp * plane_cells + sl.cell;
        if (a.dir_mask[e]) sl.fixed |= 1u << comp;
        sl.dv[comp] = a.dir_vals[e];
        sl.y[comp] = y_in[static_cast<size_t>(sl.cell) * N + comp];
      }
    }
  }
  // every block of a cluster has started and loaded its rows before any
  // writes into a neighbour's halo rows
  barrier(cluster_size);
  K5_SPLIT_MARK(0);

  float* prev_a = nullptr;
  float* prev_b = nullptr;
  float* next_a = nullptr;
  float* next_b = nullptr;
  if (cluster_size > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (rank > 0) {
      prev_a = cluster.map_shared_rank(buffer_a, rank - 1);
      prev_b = cluster.map_shared_rank(buffer_b, rank - 1);
    }
    if (rank < cluster_size - 1) {
      next_a = cluster.map_shared_rank(buffer_a, rank + 1);
      next_b = cluster.map_shared_rank(buffer_b, rank + 1);
    }
  }
  const Target to_a = {buffer_a, prev_a, next_a, stride,
                       w,        r0,     r1 - 1, a.slab_rows + 1};
  const Target to_b = {buffer_b, prev_b, next_b, stride,
                       w,        r0,     r1 - 1, a.slab_rows + 1};
  const Planes in_a = {buffer_a, stride, w};
  const Planes in_b = {buffer_b, stride, w};
  const Faces faces = {grm, grv, gcm, gcv, N, inv_r};

  for (int step = 0; step < a.n_steps; ++step) {
    const size_t frame_offset =
        (b * a.n_steps + step) * plane_cells * static_cast<size_t>(N);
    if constexpr (Equation::kRK4) {
      rk4_stage<Equation, Grid, 0, CELLS, WRITE_TRAJECTORY>(
          slots, in_a, to_b, p, faces, a, frame_offset);
      K5_SPLIT_MARK(1);
      barrier(cluster_size);
      K5_SPLIT_MARK(2);
      rk4_stage<Equation, Grid, 1, CELLS, WRITE_TRAJECTORY>(
          slots, in_b, to_a, p, faces, a, frame_offset);
      K5_SPLIT_MARK(3);
      barrier(cluster_size);
      K5_SPLIT_MARK(4);
      rk4_stage<Equation, Grid, 2, CELLS, WRITE_TRAJECTORY>(
          slots, in_a, to_b, p, faces, a, frame_offset);
      K5_SPLIT_MARK(5);
      barrier(cluster_size);
      K5_SPLIT_MARK(6);
      rk4_stage<Equation, Grid, 3, CELLS, WRITE_TRAJECTORY>(
          slots, in_b, to_a, p, faces, a, frame_offset);
      K5_SPLIT_MARK(7);
      barrier(cluster_size);
      K5_SPLIT_MARK(8);
    } else {
      cahn_hilliard_first<Grid, CELLS>(slots, in_a, to_b, p, faces);
      K5_SPLIT_MARK(1);
      barrier(cluster_size);
      K5_SPLIT_MARK(2);
      cahn_hilliard_second<Grid, CELLS, WRITE_TRAJECTORY>(
          slots, in_b, to_a, p, faces, a, frame_offset);
      K5_SPLIT_MARK(3);
      barrier(cluster_size);
      K5_SPLIT_MARK(4);
    }
  }
  if constexpr (!WRITE_TRAJECTORY) {
    float* y_out = static_cast<float*>(a.out) + b * plane_cells * N;
#pragma unroll
    for (int s = 0; s < CELLS; ++s) {
      if (!slots[s].valid) continue;
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        y_out[static_cast<size_t>(slots[s].cell) * N + comp] =
            slots[s].y[comp];
      }
    }
  }
  K5_SPLIT_MARK(9);
  K5_SPLIT_END
}

template <class Equation, class Grid, int CELLS, int MAX_THREADS>
const void* select_mode(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   fused_system_rk4_kernel<Equation, Grid, CELLS,
                                           MAX_THREADS, true>)
             : reinterpret_cast<const void*>(
                   fused_system_rk4_kernel<Equation, Grid, CELLS,
                                           MAX_THREADS, false>);
}

// The instance for `threads` threads of `cells` cells each: one cell a
// thread in blocks of up to 512 or 1,024 threads, two in blocks of up to
// 1,024.
template <class Equation, class Grid>
const void* select_cells(int cells, int threads, int write_trajectory) {
  if (cells == 2) {
    return select_mode<Equation, Grid, 2, kMaxThreads>(write_trajectory);
  }
  return threads <= kMaxThreads / 2
             ? select_mode<Equation, Grid, 1, kMaxThreads / 2>(
                   write_trajectory)
             : select_mode<Equation, Grid, 1, kMaxThreads>(write_trajectory);
}

template <class Equation>
const void* select_kernel(int polar, int cells, int threads,
                          int write_trajectory) {
  return polar ? select_cells<Equation, PolarWholeGrid>(cells, threads,
                                                        write_trajectory)
               : select_cells<Equation, WholeGrid>(cells, threads,
                                                   write_trajectory);
}

// The dynamic shared memory a block of the kernel takes for an H x W grid
// of n-component states split over cluster_size blocks (1 for one block a
// state): two sets of n float planes of its rows and two halo rows, the
// float Neumann face vectors, on a polar grid the H floats of 1 / r, and
// the byte masks.
size_t shared_bytes_of(int height, int width, int n, int polar,
                                 int cluster_size) {
  const size_t slab_rows = (height + cluster_size - 1) / cluster_size;
  const size_t faces = 2 * static_cast<size_t>(n) * (height + width);
  return 4 * (2 * n * (slab_rows + 2) * width + faces +
              (polar ? height : 0)) +
         faces;
}

}  // namespace

extern "C" {

const char* fused_system_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

#ifdef K5_STEP_SPLIT
// Points the step split's marks at `sums` (kSplitSegments long longs for
// each warp of block 0), or turns them off (null).
int fused_system_split_buffer(void* sums) {
  long long* pointer = static_cast<long long*>(sums);
  return static_cast<int>(
      cudaMemcpyToSymbol(k5_split_sums, &pointer, sizeof(pointer)));
}

int fused_system_split_segments() { return kSplitSegments; }
#endif

// Launches one CTA per state of y0 ((batch, H, W, n) float32, contiguous)
// on `stream`, or one cluster of cluster_size blocks (2, 4 or 8) per
// state, for the equation `equation` (system_2d.cuh EquationId) on a
// Cartesian or (polar != 0, with the H values of 1 / r in inv_r) a polar
// grid. A trajectory's frames are float32 or (frame_bfloat16) bfloat16.
// The constant tensors are the Dirichlet grids (n, H, W) and the Neumann
// face vectors described in system_2d.cuh. `coefficients` holds the
// kCoefficients floats of system_2d.cuh make_params. Returns the
// cudaError_t of the launch (0 on success): cudaErrorInvalidValue for a
// block that lists more than 2,048 cells (two a thread; the caller takes a
// larger cluster there) or takes more shared memory than a block holds,
// cudaErrorCooperativeLaunchTooLarge, without launching, for a
// cluster the card cannot place; the caller raises on anything but 0.
int fused_system_rk4(int equation, int polar, const float* y0, void* out,
                     int batch, int height, int width, int n_steps,
                     int write_trajectory, int frame_bfloat16,
                     int cluster_size, const uint8_t* dir_mask,
                     const float* dir_vals, const uint8_t* ghost_row_mask,
                     const float* ghost_row_vals,
                     const uint8_t* ghost_col_mask,
                     const float* ghost_col_vals, const float* inv_r,
                     const float* coefficients, void* stream) {
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3 ||
      (polar && inv_r == nullptr) ||
      !(cluster_size == 1 || cluster_size == 2 || cluster_size == 4 ||
        cluster_size == 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slab_rows = (height + cluster_size - 1) / cluster_size;
  // every block of the cluster holds at least one row
  if ((cluster_size - 1) * slab_rows >= height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one or two cells a thread (the kernel's instances): past 2,048 cells
  // a block, the caller takes a larger cluster
  const int block_cells = slab_rows * width;
  const int cells = block_cells <= kMaxThreads ? 1 : 2;
  int threads = (block_cells + cells - 1) / cells;
  threads = ((threads + 31) / 32) * 32;
  int n = 0;
  const void* kernel = nullptr;
  switch (equation) {
    case kWave2D:
      kernel = select_kernel<Wave2D>(polar, cells, threads, write_trajectory);
      n = Wave2D::kComponents;
      break;
    case kBurgers2D:
      kernel = select_kernel<Burgers2D>(polar, cells, threads,
                                        write_trajectory);
      n = Burgers2D::kComponents;
      break;
    case kShallowWater2D:
      kernel = select_kernel<ShallowWater2D>(polar, cells, threads,
                                             write_trajectory);
      n = ShallowWater2D::kComponents;
      break;
    case kCahnHilliard2D:
      kernel = select_kernel<CahnHilliard2D>(polar, cells, threads,
                                             write_trajectory);
      n = CahnHilliard2D::kComponents;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared_bytes =
      shared_bytes_of(height, width, n, polar, cluster_size);
  if (block_cells > 2 * kMaxThreads || shared_bytes > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  if (shared_bytes > 48 * 1024) {
    cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  Args a;
  a.p = make_params(height, width, coefficients);
  a.y0 = y0;
  a.out = out;
  a.n_steps = n_steps;
  a.frame_bfloat16 = frame_bfloat16;
  a.dir_mask = dir_mask;
  a.dir_vals = dir_vals;
  a.grm = ghost_row_mask;
  a.grv = ghost_row_vals;
  a.gcm = ghost_col_mask;
  a.gcv = ghost_col_vals;
  a.inv_r = inv_r;
  a.cluster_size = cluster_size;
  a.slab_rows = slab_rows;
  void* args[] = {&a};

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
  config.numAttrs = cluster_size > 1 ? 1 : 0;
  cudaError_t error;
  if (cluster_size > 1) {
    // a cluster whose blocks the card cannot hold at once would never
    // start: refuse it instead
    int clusters = 0;
    error = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (error != cudaSuccess) return static_cast<int>(error);
    if (clusters < 1) {
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
  }
  error = cudaLaunchKernelExC(&config, kernel, args);
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
