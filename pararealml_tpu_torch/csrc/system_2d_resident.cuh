// The resident RK4 kernel template for multi-component 2D systems, shared
// by the whole-grid kernels (K5 and K4, fused_system.cu) and the
// cluster-resident mode past one block (cluster_system.cu): one CTA, or a
// thread block cluster splitting the rows, keeps one state on chip for all
// n_steps, each thread owning fixed cells with their state and RK4
// accumulator in registers, the stage input ping-ponged between two plane
// sets in shared memory and pushed into the neighbours' halo rows through
// distributed shared memory, one barrier a stage. fused_system.cu's header
// gives the design and what it computes; each source picks its own
// instances (cells a thread, threads a block) and launch rules.

#pragma once

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

namespace resident2d {

using namespace state_io;
using namespace system2d;

constexpr int kMaxThreads = 1024;

// The kernel's arguments: the state and its output, the Dirichlet grids
// (n, H, W) in device memory, the Neumann face vectors of system_2d.cuh
// and, on a polar grid, the H values of 1 / r; the blocks of a cluster
// split the rows as evenly as they divide (block_rows), the first ones a
// row more: slab_rows, the most a block holds, sizes its planes.
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

// The first of the H grid rows that block `rank` of a cluster of
// cluster_size owns (rank == cluster_size: H): the rows split as evenly as
// they divide, the first H % cluster_size blocks holding a row more, so
// that every block holds at least one row wherever cluster_size <= H.
__host__ __device__ __forceinline__ int first_row(int rank, int height,
                                                  int cluster_size) {
  const int base = height / cluster_size;
  const int extra = height % cluster_size;
  return rank * base + (rank < extra ? rank : extra);
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
  const int r0 = first_row(rank, h, cluster_size);
  const int r1 = first_row(rank + 1, h, cluster_size);
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
  // the block above holds the rows from first_row(rank - 1) to r0
  const int prev_halo =
      rank > 0 ? r0 - first_row(rank - 1, h, cluster_size) + 1 : 0;
  const Target to_a = {buffer_a, prev_a, next_a, stride,
                       w,        r0,     r1 - 1, prev_halo};
  const Target to_b = {buffer_b, prev_b, next_b, stride,
                       w,        r0,     r1 - 1, prev_halo};
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

// The dynamic shared memory a block of the kernel takes for an H x W grid
// of n-component states split over cluster_size blocks (1 for one block a
// state): two sets of n float planes of its largest slab's rows and two
// halo rows, the float Neumann face vectors, on a polar grid the H floats
// of 1 / r, and the byte masks.
inline size_t shared_bytes_of(int height, int width, int n, int polar,
                              int cluster_size) {
  const size_t slab_rows = (height + cluster_size - 1) / cluster_size;
  const size_t faces = 2 * static_cast<size_t>(n) * (height + width);
  return 4 * (2 * n * (slab_rows + 2) * width + faces +
              (polar ? height : 0)) +
         faces;
}

}  // namespace resident2d
