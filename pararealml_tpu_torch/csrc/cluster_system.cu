// The cluster-resident mode of the 2D system kernels, for Hopper
// (sm_90a): one thread block cluster of up to 16 blocks keeps a state
// that one block cannot hold on chip for a whole solve, in one launch,
// for the wave, Burgers, shallow-water and Cahn-Hilliard systems on
// Cartesian and polar meshes with static boundary conditions (Dirichlet
// constraints anywhere in the grid, as a dense mask).
//
// Replaces, on the 2D examples' grids (101 x 101, 101 x 51, the polar
// 51 x 201) and any grid past one block up to the cluster's range, the
// JAX package's Pallas TPU kernels
//   ops/fused_system.py  K5 build_fused_system_rk4_trajectory,
//                           build_fused_system_rk4_end (single or batched)
//                           and build_fused_system_rk4_step,
// which the JAX package runs on every grid within its VMEM cap (about
// 400 x 400 for two components): the port ran those grids on the tiled
// kernel K8 (tiled_system.cu), one launch a step, in the tiled helpers'
// order. This mode computes what K5 computes, term for term and in K5's
// order (system_2d.cuh: each axis's Neumann ghost term added first), so
// it is bit for bit with K5's plain PyTorch version.
//
// What bounds it on the card: neither bytes nor operations. The examples'
// states are 82 to 250 KB and a step is 35 to 323 operations a cell: a
// step is a chain of four dependent stages (two for Cahn-Hilliard). K8's
// step split on the wave example (tools/k8_step_split.py, NVIDIA H100
// 80GB HBM3 at 700 W) put 6.5 us into a step: a 2.4 us gap between
// launches, 0.8 us loading the tile with its halo, 3.1 us in four stages
// that recompute the halo ring (776 cell-stages for 96 cells) and 0.6 us
// storing the frame.
//
// What the design does about it. The kernel is the resident template of
// system_2d_resident.cuh that K5 runs (one launch a solve, the state read
// once, each thread owning fixed cells with state and accumulator in
// registers, the stage input ping-ponged between two plane sets in shared
// memory), here on clusters of 2 to 16 blocks (past 8 as a non-portable
// cluster size), each block a slab of rows (the rows split as evenly as
// they divide, so any size up to H rows gives every block a row), its
// edge rows pushed into the neighbours' halo rows through distributed
// shared memory with one cluster barrier a stage. No halo is recomputed
// and no step goes through device memory: the only traffic is the
// initial read and the frames (float32, or bfloat16 as K4 stores them) or
// the end state. Each thread owns 1, 2 or 4 cells in blocks of at most 512
// threads (128 registers a thread; every 4-cell instance spills, and
// shallow water's 2-cell ones), or one cell in blocks of up to 1,024 (64
// registers; shallow water's spill), which ran the wave and Cahn-Hilliard
// examples 3-5% faster than two cells in 512 (tools/cluster_plan_sweep.py,
// NVIDIA H100 80GB HBM3 at 700 W). A batch is one cluster a state. The host
// plans the cluster size and cells a thread from a table measured on the
// card (ops/fused_system.py make_cluster_plan); for a batch it asks
// cluster_system_max_active_clusters how many clusters of a size the card
// places at once. A cluster the card cannot place is refused before any
// launch.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include "system_2d_resident.cuh"

namespace {

using namespace resident2d;
using namespace system2d;

// the most threads a block of this mode has (1,024 with one cell a
// thread), and the most cells a thread owns: a block holds at most 2,048
// cells
constexpr int kClusterThreads = 512;
constexpr int kMaxCells = 4;
constexpr int kMaxClusterSize = 16;

template <class Equation, class Grid>
const void* select_cells(int cells, int threads, int write_trajectory) {
  switch (cells) {
    case 1:
      return threads <= kClusterThreads
                 ? select_mode<Equation, Grid, 1, kClusterThreads>(
                       write_trajectory)
                 : select_mode<Equation, Grid, 1, kMaxThreads>(
                       write_trajectory);
    case 2:
      return select_mode<Equation, Grid, 2, kClusterThreads>(
          write_trajectory);
    case 4:
      return select_mode<Equation, Grid, 4, kClusterThreads>(
          write_trajectory);
    default:
      return nullptr;
  }
}

template <class Equation>
const void* select_kernel(int polar, int cells, int threads,
                          int write_trajectory) {
  return polar ? select_cells<Equation, PolarWholeGrid>(cells, threads,
                                                        write_trajectory)
               : select_cells<Equation, WholeGrid>(cells, threads,
                                                   write_trajectory);
}

// Checks a launch's shape, picks the kernel and fills the launch
// configuration (its cluster attribute in `attribute`) and the slab rows.
// Returns the cudaError_t (0 on success).
int configure(int equation, int polar, int batch, int height, int width,
              int write_trajectory, int cluster_size, int cells,
              const void** kernel, cudaLaunchConfig_t* config,
              cudaLaunchAttribute* attribute, int* slab_rows) {
  if (batch <= 0 || height < 3 || width < 3 || cluster_size < 1 ||
      cluster_size > kMaxClusterSize || cluster_size > height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *slab_rows = (height + cluster_size - 1) / cluster_size;
  const int block_cells = *slab_rows * width;
  int threads = (block_cells + cells - 1) / cells;
  threads = ((threads + 31) / 32) * 32;
  if (threads > (cells == 1 ? kMaxThreads : kClusterThreads) ||
      cells > kMaxCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n = 0;
  switch (equation) {
    case kWave2D:
      *kernel = select_kernel<Wave2D>(polar, cells, threads,
                                    write_trajectory);
      n = Wave2D::kComponents;
      break;
    case kBurgers2D:
      *kernel = select_kernel<Burgers2D>(polar, cells, threads,
                                    write_trajectory);
      n = Burgers2D::kComponents;
      break;
    case kShallowWater2D:
      *kernel = select_kernel<ShallowWater2D>(polar, cells, threads,
                                    write_trajectory);
      n = ShallowWater2D::kComponents;
      break;
    case kCahnHilliard2D:
      *kernel = select_kernel<CahnHilliard2D>(polar, cells, threads,
                                    write_trajectory);
      n = CahnHilliard2D::kComponents;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (*kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes =
      shared_bytes_of(height, width, n, polar, cluster_size);
  if (shared_bytes > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t error = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (error != cudaSuccess) return static_cast<int>(error);
  if (cluster_size > 8) {
    error = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = cluster_size;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(static_cast<unsigned>(batch) * cluster_size);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = shared_bytes;
  config->attrs = attribute;
  config->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

const char* cluster_system_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// How many clusters of cluster_size blocks of the kernel for `equation`
// on an H x W grid, with `cells` cells a thread, the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters. Returns the
// cudaError_t (0 on success).
int cluster_system_max_active_clusters(int equation, int polar, int height,
                                       int width, int write_trajectory,
                                       int cluster_size, int cells,
                                       int* clusters) {
  const void* kernel = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int slab_rows = 0;
  int error = configure(equation, polar, 1, height, width, write_trajectory,
                        cluster_size, cells, &kernel, &config, &attribute,
                        &slab_rows);
  if (error != 0) return error;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &config));
}

// Launches one cluster of cluster_size blocks (1 to 16, at most H) per
// state of y0 ((batch, H, W, n) float32, contiguous) on `stream`, each
// thread owning up to `cells` cells (1, 2 or 4; at most 1,024 threads a
// block of one cell, 512 of two or four), for the equation `equation` (system_2d.cuh EquationId) on a
// Cartesian or (polar != 0, with the H values of 1 / r in inv_r) a polar
// grid, over n_steps steps. write_trajectory: out is (batch, n_steps, H,
// W, n), float32 or (frame_bfloat16) bfloat16, and receives every step;
// otherwise out is (batch, H, W, n) float32 and receives the end. The
// constant tensors are the Dirichlet grids (n, H, W) and the Neumann face
// vectors described in system_2d.cuh; `coefficients` holds the
// kCoefficients floats of system_2d.cuh make_params. Returns the
// cudaError_t of the launch (0 on success): cudaErrorInvalidValue for a
// shape the instances do not take (too many threads a block, more shared
// memory than a block holds), cudaErrorCooperativeLaunchTooLarge,
// without launching, for a cluster the card cannot place; the caller
// raises on anything but 0.
int cluster_system_rk4(int equation, int polar, const float* y0, void* out,
                       int batch, int height, int width, int n_steps,
                       int write_trajectory, int frame_bfloat16,
                       int cluster_size, int cells, const uint8_t* dir_mask,
                       const float* dir_vals, const uint8_t* ghost_row_mask,
                       const float* ghost_row_vals,
                       const uint8_t* ghost_col_mask,
                       const float* ghost_col_vals, const float* inv_r,
                       const float* coefficients, void* stream) {
  if (n_steps <= 0 || (polar && inv_r == nullptr) ||
      (frame_bfloat16 && !write_trajectory)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int slab_rows = 0;
  int error = configure(equation, polar, batch, height, width,
                        write_trajectory, cluster_size, cells, &kernel,
                        &config, &attribute, &slab_rows);
  if (error != 0) return error;
  config.stream = static_cast<cudaStream_t>(stream);
  // a cluster whose blocks the card cannot hold at once would never
  // start: refuse it instead
  int clusters = 0;
  cudaError_t status =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (clusters < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
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
  status = cudaLaunchKernelExC(&config, kernel, args);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
