// Tiled RK4 trajectory kernel for multi-component 2D systems past one
// thread block (K8), for Hopper (sm_90a): wave, Burgers, shallow water and
// Cahn-Hilliard with static boundary conditions whose Dirichlet
// constraints lie on the grid's faces, on Cartesian and polar meshes.
//
// Replaces the JAX package's Pallas TPU kernel
//   K8 ops/tiled_system.py build_tiled_system_rk4_trajectory
// (the state in device memory, row tiles of all n planes streamed through
// one core with 8-row halos recomputed, every step written to the
// trajectory). It computes what that kernel computes, per step and in the
// same order, through the equation functors of system_2d.cuh that the
// whole-grid kernel (K5, fused_system.cu) runs too, with the tiled
// helpers' Laplacian (the two axis terms summed, then the Neumann ghost
// rows, then the ghost columns). For the wave, Burgers and shallow-water
// systems, classic RK4:
//   k1 = f(y), k2 = f(D(y + (d_t/2) k1)), k3 = f(D(y + (d_t/2) k2)),
//   k4 = f(D(y + d_t k3)), y' = D(y + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
// and for Cahn-Hilliard its own two-stage step; D is the Dirichlet
// override as face vectors, rows then columns. These systems are not
// affine (Burgers, shallow water and Cahn-Hilliard are nonlinear), so the
// Horner form of the diffusion kernels (K6, K7) does not apply: each block
// keeps the state, two stage buffers and the RK4 accumulator of its tile.
//
// Polar meshes: the JAX package has no tiled polar kernel; its polar K5
// (ops/fused_system.py _StencilHelpers with inv_r) covers polar grids up to
// its VMEM cap, and the port's polar K8 is that K5 past one block. So a
// polar tile (system_2d.cuh PolarTile) keeps K5's order of operations
// (each axis's ghost added first, then d2_0 + (d2_1 inv_r + d_0) inv_r)
// and reads 1 / r of its rows from the H values the host passes; it
// matches the polar whole-grid kernel bit for bit. The halo stays 4: the
// polar terms read only the row neighbours the Laplacian reads.
//
// What bounds it on the card. At 641 x 641 x 2 (Burgers) a step writes one
// frame of 3.3 MB (1.0 us at 3.35 TB/s; half of that in bfloat16) and
// does 162 operations a cell (1.0 us at 67 TFLOP/s), so neither dominates
// by much; with a shared-memory tile each stage costs a dozen
// shared-memory accesses a cell and component, which is the practical
// limit there. At the examples' 101 x 101 and 101 x 51 grids a step is a
// few microseconds of latency (one launch, a tile load, four dependent
// stages with their barriers, a store) over 10,000 cells.
//
// What the design does about it. A step of one tile needs its
// neighbours' previous step, so steps are separated grid-wide: one launch
// per RK4 step, with every state of a batch in the launch's third grid
// dimension. A block loads its tile with a halo (4 cells for RK4, whose
// four chained radius-1 stencils reach 4; 1 for Cahn-Hilliard's single
// radius-1 dependence) into shared memory as n planes, converting from
// bfloat16 where the state is stored so, runs the stages there over a
// region that shrinks by one ring per stage (cells outside the grid hold
// zero, which is the generic path's zero halo), and writes its part of
// the step's frame in the JAX package's (steps, H, W, n) layout. The frame
// is the carried state: the next step reads it, so the state is never
// written twice and, in bfloat16, rounds exactly once a step, as in the
// JAX kernel. The host's tile plan (ops/tiled_system.py
// make_system_tile_plan) sizes the tile by grid and by n so that the
// blocks fill the card in one wave where they can; the last tile of a
// row or column is clamped inside the grid and overlaps its neighbour,
// which then writes the same values. The TPU kernel's sublane and lane
// padding, 256-row tile caps and DMA rings are not carried over. Making
// it fast (several steps a launch, a persistent or cluster-resident
// variant for grids just past one block, TMA tile loads) is later work.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "state_io.cuh"
#include "system_2d.cuh"

namespace {

using namespace state_io;
using namespace system2d;

constexpr int kRK4Halo = 4;
constexpr int kCahnHilliardHalo = 1;

// The Dirichlet face vectors in device memory: rows (2 faces, n, W) and
// columns (2 faces, n, H), the lower face first, values premasked.
struct DirichletFaces {
  const uint8_t* row_mask;
  const float* row_vals;
  const uint8_t* col_mask;
  const float* col_vals;
};

struct TiledArgs {
  Params p;
  Faces ghost;
  DirichletFaces dir;
  // the shared-memory tile, halo included, and its halo
  int rows;
  int cols;
  int halo;
  int n_steps;
  int step;
  int state_bfloat16;
  // the states this step starts from: state b at source + b *
  // source_stride elements
  int source_kind;
  const void* source;
  size_t source_stride;
  // (B, n_steps, H, W, n) frames of the stored type
  void* traj;
};

// The first grid row (or column) of tile t: tiles of `tile` cells, the
// last one clamped inside the grid.
__device__ __forceinline__ int tile_start(int t, int tile, int extent) {
  return min(t * tile, max(extent - tile, 0));
}

// make_dirichlet's override of component `comp` at a cell: the row faces,
// then the column faces.
__device__ __forceinline__ float dirichlet(const TiledArgs& a, int comp,
                                           const Cell& x, float value) {
  const Params& p = a.p;
  const int n = a.ghost.n;
  if (x.i == 0) {
    const int face = comp * p.width + x.j;
    if (a.dir.row_mask[face]) value = a.dir.row_vals[face];
  } else if (x.i == p.height - 1) {
    const int face = (n + comp) * p.width + x.j;
    if (a.dir.row_mask[face]) value = a.dir.row_vals[face];
  }
  if (x.j == 0) {
    const int face = comp * p.height + x.i;
    if (a.dir.col_mask[face]) value = a.dir.col_vals[face];
  } else if (x.j == p.width - 1) {
    const int face = (n + comp) * p.height + x.i;
    if (a.dir.col_mask[face]) value = a.dir.col_vals[face];
  }
  return value;
}

// Stage STAGE (0-3) of an RK4 step over the tile region STAGE + 1 cells
// inside its edge, reading `in` and writing the accumulator and `next`
// (STAGE < 3) or the state `y` in place (STAGE == 3: each thread rewrites
// only its own cells of y, which no other thread reads in this stage).
// Cells outside the grid are written as zero.
template <class Equation, class Grid, int STAGE>
__device__ __forceinline__ void rk4_stage(const TiledArgs& a,
                                          const Planes& in, float* next,
                                          float* y, float* acc, int gi0,
                                          int gj0) {
  constexpr int N = Equation::kComponents;
  const Params& p = a.p;
  const int m = STAGE + 1;
  const int plane = in.stride;
  float k[N];
  for (int li = m + threadIdx.y; li < a.rows - m; li += blockDim.y) {
    const int gi = gi0 + li;
    const bool row_in_grid = gi >= 0 && gi < p.height;
    for (int lj = m + threadIdx.x; lj < a.cols - m; lj += blockDim.x) {
      const int gj = gj0 + lj;
      const int idx = li * a.cols + lj;
      if (!(row_in_grid && gj >= 0 && gj < p.width)) {
        if constexpr (STAGE < 3) {
#pragma unroll
          for (int comp = 0; comp < N; ++comp) next[comp * plane + idx] = 0.0f;
        }
        continue;
      }
      const Cell x = {gi, gj, idx};
      Equation::template rhs<Grid>(in, x, p, a.ghost, k);
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        const int e = comp * plane + idx;
        if constexpr (STAGE == 0) {
          acc[e] = k[comp];
          next[e] = dirichlet(a, comp, x, y[e] + p.half_d_t * k[comp]);
        } else if constexpr (STAGE == 1) {
          acc[e] = acc[e] + 2.0f * k[comp];
          next[e] = dirichlet(a, comp, x, y[e] + p.half_d_t * k[comp]);
        } else if constexpr (STAGE == 2) {
          acc[e] = acc[e] + 2.0f * k[comp];
          next[e] = dirichlet(a, comp, x, y[e] + p.d_t * k[comp]);
        } else {
          y[e] = dirichlet(a, comp, x, y[e] + p.sixth_d_t * (acc[e] + k[comp]));
        }
      }
    }
  }
}

// One Cahn-Hilliard step of the tile (halo 1): the first stage stores
// D1(y1) in stage_a over the whole tile and k1 and D1(potential) in the
// accumulator one cell inside its edge; the second updates y in place
// there. A block barrier follows each.
template <class Grid>
__device__ __forceinline__ void cahn_hilliard_step(const TiledArgs& a,
                                                   float* y, float* stage_a,
                                                   float* acc, int gi0,
                                                   int gj0) {
  const Params& p = a.p;
  const int plane = a.rows * a.cols;
  const Planes state_in = {y, plane, a.cols};
  const Planes stage_in = {stage_a, plane, a.cols};
  for (int li = threadIdx.y; li < a.rows; li += blockDim.y) {
    const int gi = gi0 + li;
    const bool row_in_grid = gi >= 0 && gi < p.height;
    const bool row_inner = li >= 1 && li < a.rows - 1;
    for (int lj = threadIdx.x; lj < a.cols; lj += blockDim.x) {
      const int gj = gj0 + lj;
      const int idx = li * a.cols + lj;
      if (!(row_in_grid && gj >= 0 && gj < p.width)) {
        stage_a[plane + idx] = 0.0f;
        continue;
      }
      const Cell x = {gi, gj, idx};
      stage_a[plane + idx] = dirichlet(a, 1, x, y[plane + idx]);
      if (row_inner && lj >= 1 && lj < a.cols - 1) {
        float k1, potential;
        CahnHilliard2D::first<Grid>(state_in, x, p, a.ghost, &k1,
                                    &potential);
        acc[idx] = k1;
        acc[plane + idx] = dirichlet(a, 1, x, potential);
      }
    }
  }
  __syncthreads();
  for (int li = 1 + threadIdx.y; li < a.rows - 1; li += blockDim.y) {
    const int gi = gi0 + li;
    if (gi < 0 || gi >= p.height) continue;
    for (int lj = 1 + threadIdx.x; lj < a.cols - 1; lj += blockDim.x) {
      const int gj = gj0 + lj;
      if (gj < 0 || gj >= p.width) continue;
      const int idx = li * a.cols + lj;
      const Cell x = {gi, gj, idx};
      const float rest = CahnHilliard2D::k_rest<Grid>(stage_in, x, p, a.ghost);
      const float combined = acc[idx] + 5.0f * rest;
      y[idx] = dirichlet(a, 0, x, y[idx] + p.sixth_d_t * combined);
      y[plane + idx] = acc[plane + idx];
    }
  }
  __syncthreads();
}

// One RK4 step: block (bx, by, b) advances its tile of state b from
// `source` and writes its part of frame `step` of state b.
template <class Equation, class Grid>
__global__ void __launch_bounds__(512) tiled_system_kernel(const TiledArgs a) {
  constexpr int N = Equation::kComponents;
  extern __shared__ __align__(16) float shared[];
  const Params& p = a.p;
  const int rows = a.rows;
  const int cols = a.cols;
  const int halo = a.halo;
  const int plane = rows * cols;
  // layout (sized by the plan's shared_bytes in ops/tiled_system.py):
  // the state, two stage buffers and the accumulator, n planes each
  float* y = shared;
  float* stage_a = y + N * plane;
  float* stage_b = stage_a + N * plane;
  float* acc = stage_b + N * plane;
  const int tile_h = rows - 2 * halo;
  const int tile_w = cols - 2 * halo;
  const int gi0 = tile_start(blockIdx.y, tile_h, p.height) - halo;
  const int gj0 = tile_start(blockIdx.x, tile_w, p.width) - halo;
  const size_t b = blockIdx.z;
  const size_t values = static_cast<size_t>(p.height) * p.width * N;
  const size_t source_base = b * a.source_stride;

  // the state arrives interleaved ((H, W, n)) and is kept as planes
  for (int li = threadIdx.y; li < rows; li += blockDim.y) {
    const int gi = gi0 + li;
    const bool row_in_grid = gi >= 0 && gi < p.height;
    for (int lj = threadIdx.x; lj < cols; lj += blockDim.x) {
      const int gj = gj0 + lj;
      const int idx = li * cols + lj;
      if (row_in_grid && gj >= 0 && gj < p.width) {
        const size_t cell =
            source_base + (static_cast<size_t>(gi) * p.width + gj) * N;
#pragma unroll
        for (int comp = 0; comp < N; ++comp) {
          y[comp * plane + idx] =
              load_state(a.source, a.source_kind, cell + comp);
        }
      } else {
#pragma unroll
        for (int comp = 0; comp < N; ++comp) y[comp * plane + idx] = 0.0f;
      }
    }
  }
  __syncthreads();

  if constexpr (Equation::kRK4) {
    const Planes y_in = {y, plane, cols};
    const Planes a_in = {stage_a, plane, cols};
    const Planes b_in = {stage_b, plane, cols};
    rk4_stage<Equation, Grid, 0>(a, y_in, stage_a, y, acc, gi0, gj0);
    __syncthreads();
    rk4_stage<Equation, Grid, 1>(a, a_in, stage_b, y, acc, gi0, gj0);
    __syncthreads();
    rk4_stage<Equation, Grid, 2>(a, b_in, stage_a, y, acc, gi0, gj0);
    __syncthreads();
    rk4_stage<Equation, Grid, 3>(a, a_in, nullptr, y, acc, gi0, gj0);
    __syncthreads();
  } else {
    cahn_hilliard_step<Grid>(a, y, stage_a, acc, gi0, gj0);
  }

  const size_t frame = (b * a.n_steps + a.step) * values;
  for (int li = halo + threadIdx.y; li < halo + tile_h; li += blockDim.y) {
    const int gi = gi0 + li;
    if (gi >= p.height) break;
    for (int lj = halo + threadIdx.x; lj < halo + tile_w; lj += blockDim.x) {
      const int gj = gj0 + lj;
      if (gj >= p.width) break;
      const int idx = li * cols + lj;
      const size_t cell =
          frame + (static_cast<size_t>(gi) * p.width + gj) * N;
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        store_state(a.traj, a.state_bfloat16, cell + comp,
                    y[comp * plane + idx]);
      }
    }
  }
}

template <class Equation>
const void* select_kernel(int polar) {
  return polar ? reinterpret_cast<const void*>(
                     tiled_system_kernel<Equation, PolarTile>)
               : reinterpret_cast<const void*>(
                     tiled_system_kernel<Equation, Tile>);
}

// The kernel of `equation` on a Cartesian or polar tile, with its
// component count and the halo it needs; false for an unknown equation.
bool select_equation(int equation, int polar, const void** kernel, int* components,
            int* needed_halo) {
  *needed_halo = kRK4Halo;
  switch (equation) {
    case kWave2D:
      *kernel = select_kernel<Wave2D>(polar);
      *components = Wave2D::kComponents;
      return true;
    case kBurgers2D:
      *kernel = select_kernel<Burgers2D>(polar);
      *components = Burgers2D::kComponents;
      return true;
    case kShallowWater2D:
      *kernel = select_kernel<ShallowWater2D>(polar);
      *components = ShallowWater2D::kComponents;
      return true;
    case kCahnHilliard2D:
      *kernel = select_kernel<CahnHilliard2D>(polar);
      *components = CahnHilliard2D::kComponents;
      *needed_halo = kCahnHilliardHalo;
      return true;
    default:
      return false;
  }
}

// Checks the launch's arguments, opts the kernel into `shared_bytes` and
// fills the step-independent part of its arguments. Returns the
// cudaError_t (0 on success).
int prepare(int equation, int polar, int batch, int height, int width,
            int n_steps, int rows, int cols, int halo, size_t shared_bytes,
            const uint8_t* dir_row_mask, const float* dir_row_vals,
            const uint8_t* ghost_row_mask, const float* ghost_row_vals,
            const uint8_t* dir_col_mask, const float* dir_col_vals,
            const uint8_t* ghost_col_mask, const float* ghost_col_vals,
            const float* inv_r, const float* coefficients,
            const void** kernel, TiledArgs* a, dim3* blocks,
            dim3* threads) {
  int components = 0;
  int needed_halo = 0;
  if (!select_equation(equation, polar, kernel, &components, &needed_halo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_h = rows - 2 * halo;
  const int tile_w = cols - 2 * halo;
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3 ||
      halo < needed_halo || tile_h <= 0 || tile_w <= 0 ||
      (polar && inv_r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared_bytes > 48 * 1024) {
    cudaError_t error = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  a->p = make_params(height, width, coefficients);
  a->ghost = {ghost_row_mask, ghost_row_vals, ghost_col_mask, ghost_col_vals,
              components, inv_r};
  a->dir = {dir_row_mask, dir_row_vals, dir_col_mask, dir_col_vals};
  a->rows = rows;
  a->cols = cols;
  a->halo = halo;
  *blocks = dim3((width + tile_w - 1) / tile_w,
                 (height + tile_h - 1) / tile_h, batch);
  *threads = dim3(32, rows < 16 ? rows : 16);
  return 0;
}

}  // namespace

extern "C" {

const char* tiled_system_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// n_steps launches on `stream`, one per RK4 step, each advancing every
// tile of every state of the batch. y0 is (batch, H, W, n) float32; traj
// is (batch, n_steps, H, W, n) float32 or bfloat16 (storage_bfloat16),
// and frame k - 1 is the state step k starts from. The tile is rows x
// cols cells of shared memory with a halo of `halo` cells (4 for RK4, 1
// for Cahn-Hilliard at least) and takes `shared_bytes` (the host's count:
// 16 n rows cols). The face vectors, each a byte mask and premasked
// float values, are the Dirichlet and the Neumann ghost rows (2 faces, n,
// W) and columns (2 faces, n, H), the lower face first; the ghost vectors
// are the ones the whole-grid kernel reads. A polar grid (polar != 0)
// takes the H values of 1 / r in inv_r. `coefficients` holds the
// kCoefficients floats of system_2d.cuh make_params. Returns the
// cudaError_t of the first failed call (0 on success); the caller raises
// on anything else.
int tiled_system_rk4(int equation, int polar, const float* y0, void* traj,
                     int batch,
                     int height, int width, int n_steps,
                     int storage_bfloat16, int rows, int cols, int halo,
                     size_t shared_bytes, const uint8_t* dir_row_mask,
                     const float* dir_row_vals,
                     const uint8_t* ghost_row_mask,
                     const float* ghost_row_vals,
                     const uint8_t* dir_col_mask,
                     const float* dir_col_vals,
                     const uint8_t* ghost_col_mask,
                     const float* ghost_col_vals, const float* inv_r,
                     const float* coefficients, void* stream) {
  const void* kernel = nullptr;
  TiledArgs a;
  dim3 blocks, threads;
  int error = prepare(equation, polar, batch, height, width, n_steps, rows,
                      cols, halo, shared_bytes, dir_row_mask, dir_row_vals,
                      ghost_row_mask, ghost_row_vals, dir_col_mask,
                      dir_col_vals, ghost_col_mask, ghost_col_vals, inv_r,
                      coefficients, &kernel, &a, &blocks, &threads);
  if (error != 0) return error;
  a.n_steps = n_steps;
  a.state_bfloat16 = storage_bfloat16;
  a.traj = traj;
  const size_t frame_values =
      static_cast<size_t>(height) * width * a.ghost.n;
  const size_t item = storage_bfloat16 ? 2 : 4;
  for (int step = 0; step < n_steps; ++step) {
    a.step = step;
    if (step == 0) {
      // the initial state rounds to the stored type
      a.source = y0;
      a.source_kind = storage_bfloat16 ? kSourceFloatRounded : kSourceFloat;
      a.source_stride = frame_values;
    } else {
      // the previous frame is the carried state
      a.source = static_cast<const char*>(traj) +
                 (static_cast<size_t>(step) - 1) * frame_values * item;
      a.source_kind = storage_bfloat16 ? kSourceBfloat16 : kSourceFloat;
      a.source_stride = static_cast<size_t>(n_steps) * frame_values;
    }
    void* args[] = {&a};
    cudaError_t launch_error =
        cudaLaunchKernel(kernel, blocks, threads, args, shared_bytes,
                         static_cast<cudaStream_t>(stream));
    if (launch_error != cudaSuccess) return static_cast<int>(launch_error);
  }
  return static_cast<int>(cudaGetLastError());
}

// The end mode: the same n_steps launches, each step reading one float32
// (batch, H, W, n) buffer and writing the other, so that no frame is
// stored and the last step writes `out`; `scratch` is the other buffer
// (unused for one step). Neither may alias y0. The other arguments are
// tiled_system_rk4's.
int tiled_system_rk4_end(int equation, int polar, const float* y0,
                         float* out, float* scratch, int batch, int height,
                         int width, int n_steps, int rows, int cols,
                         int halo, size_t shared_bytes,
                         const uint8_t* dir_row_mask,
                         const float* dir_row_vals,
                         const uint8_t* ghost_row_mask,
                         const float* ghost_row_vals,
                         const uint8_t* dir_col_mask,
                         const float* dir_col_vals,
                         const uint8_t* ghost_col_mask,
                         const float* ghost_col_vals, const float* inv_r,
                         const float* coefficients, void* stream) {
  const void* kernel = nullptr;
  TiledArgs a;
  dim3 blocks, threads;
  int error = prepare(equation, polar, batch, height, width, n_steps, rows,
                      cols, halo, shared_bytes, dir_row_mask, dir_row_vals,
                      ghost_row_mask, ghost_row_vals, dir_col_mask,
                      dir_col_vals, ghost_col_mask, ghost_col_vals, inv_r,
                      coefficients, &kernel, &a, &blocks, &threads);
  if (error != 0) return error;
  if (out == nullptr || (n_steps > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each launch writes one state of a one-step "trajectory"
  a.n_steps = 1;
  a.step = 0;
  a.state_bfloat16 = 0;
  a.source_kind = kSourceFloat;
  a.source_stride = static_cast<size_t>(height) * width * a.ghost.n;
  const float* source = y0;
  for (int step = 0; step < n_steps; ++step) {
    // the parity that ends on `out`
    float* target = (n_steps - 1 - step) % 2 == 0 ? out : scratch;
    a.source = source;
    a.traj = target;
    void* args[] = {&a};
    cudaError_t launch_error =
        cudaLaunchKernel(kernel, blocks, threads, args, shared_bytes,
                         static_cast<cudaStream_t>(stream));
    if (launch_error != cudaSuccess) return static_cast<int>(launch_error);
    source = target;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
