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
// components, 60 x 60 for three. Larger grids take the same kernel
// template on clusters of up to 16 blocks (cluster_system.cu, the
// cluster-resident mode) up to that mode's range, and K8 past it.
//
// The kernel template lives in system_2d_resident.cuh, shared with the
// cluster-resident mode; this source picks K5's and K4's instances (one
// cell a thread in blocks of up to 512 or 1,024 threads, two in blocks of
// up to 1,024) and launch rules (clusters of 1, 2, 4 or 8 blocks).
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include "system_2d_resident.cuh"

namespace {

using namespace resident2d;
using namespace system2d;

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
