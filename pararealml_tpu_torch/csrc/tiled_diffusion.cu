// Horner-form RK4 trajectory kernels for single-component 2D Cartesian
// diffusion and convection-diffusion on large grids, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   K6 ops/tiled_diffusion.py build_tiled_diffusion_rk4_trajectory
//      (state in device memory, row tiles streamed through one core), and
//   K7 ops/resident_diffusion.py build_resident_diffusion_rk4_trajectory
//      (state resident in one core's VMEM),
// and, through K7's end mode (no frames, the end state written once),
// the JAX package's K2 end (ops/fused_diffusion.py
// build_fused_diffusion_rk4_end) on grids past one CTA; K7 also takes the
// dense Dirichlet grid where constraints lie inside the grid, which the
// JAX package's K1/K2 cover below its VMEM cap.
// Both compute what those kernels' one_step / rk4_step compute, term for
// term and in the same order, through one __device__ stage function:
// t <- D(y + (d_t / k) rhs(t)) for k = 4, 3, 2, 1, with the stage and
// diffusion coefficients folded into the stencil taps on the host, the
// single-sum Laplacian on square cells, Neumann ghost rows added to the
// boundary rows, ghost columns folded into the lateral taps (zero flux)
// or added as a fix, the Neumann stamp on the convection gradients, and
// the Dirichlet stamp D on rows, then columns. Out-of-grid neighbours
// read as zero by a bounds test. The TPU kernels' lane and sublane
// padding, roll wrap-around masks, unrolled tile loop and DMA rings are
// not carried over.
//
// What bounds them on the card. K6 at 2049 x 2049: every step moves at
// least one frame of 16.8 MB to device memory (5 us at 3.35 TB/s) and
// does 28 operations a cell (1.8 us at 67 TFLOP/s), so bytes; with a
// shared-memory tile the four stages cost about 7 shared-memory accesses
// a cell and stage, which is the practical limit. K7 at 641 x 641: one
// frame of 1.64 MB a step (0.5 us), so bytes again, but each step also
// pays one grid-wide barrier, a few microseconds of latency that no
// bandwidth hides.
//
// What the designs do about it.
// K6 is many blocks, not one core walking tiles. A step of one tile needs
// its neighbours' previous step, so residencies are separated grid-wide:
// one launch per residency of K steps. A block loads its tile with a
// 4K-cell halo into shared memory (converting from bfloat16 where the
// state is stored so), runs the 4K Horner stages there over a region that
// shrinks by one ring per stage, and writes its part of each of the K
// frames. Where the frames have the carried state's type, the next
// residency reads its input from the last frame, so the state is never
// written twice; otherwise the state ping-pongs between two buffers.
// K7 is one persistent cooperative kernel. Each block keeps its tile of
// the state (plus a 4-cell halo) in shared memory for all steps; after
// every S steps it publishes the cells within 4S of its tile's edge to an
// exchange buffer in device memory (which stays in the L2 cache), passes
// cooperative_groups::this_grid().sync(), and reads its halo ring back;
// between barriers it recomputes the halo as K6 does. So a step costs 1/S
// of a barrier (a 1-cell exchange would need four a step) against a
// haloed tile that grows with S; the plan on the host picks S. The launch
// is refused, never deadlocked, when the grid of blocks exceeds what the
// card holds at once.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "state_io.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace state_io;

constexpr int kStages = 4;
// one RK4 step's four chained radius-1 stencils reach 4 cells
constexpr int kStepHalo = 4;

struct Problem {
  int height;
  int width;
  int fold_cols;
  int square[kStages];
  float a0[kStages];
  float a1[kStages];
  float a_center[kStages];
  float cv0[kStages];
  float cv1[kStages];
  float flux0[kStages];
  float flux1[kStages];
  float two_dx0;
  float two_dx1;
  // face vectors: dir_row (2W) | ghost_row (2W) | dir_col (2H) |
  // ghost_col (2H); rows are the lower then the upper face of axis 0
  const uint8_t* masks;
  const float* values;
  // K7 only: the dense Dirichlet grid ((H, W) byte mask and values, the
  // face constraints included) where constraints lie inside the grid,
  // else null
  const uint8_t* interior_mask;
  const float* interior_vals;
};

// One Horner stage at grid cell (gi, gj): D(y + c_s rhs(t)) from the
// stage input t at the cell (`c`) and at its four neighbours (zero
// outside the grid), `y` the state at the start of the step.
template <bool HAS_CONVECTION>
__device__ __forceinline__ float horner_stage(const Problem& p, int s,
                                              int gi, int gj, float y,
                                              float c, float above,
                                              float below, float left,
                                              float right) {
  const int h = p.height;
  const int w = p.width;
  const uint8_t* drm = p.masks;
  const uint8_t* grm = drm + 2 * w;
  const uint8_t* dcm = grm + 2 * w;
  const uint8_t* gcm = dcm + 2 * h;
  const float* drv = p.values;
  const float* grv = drv + 2 * w;
  const float* dcv = grv + 2 * w;
  const float* gcv = dcv + 2 * h;
  const bool top = gi == 0;
  const bool bottom = gi == h - 1;
  const bool first = gj == 0;
  const bool last = gj == w - 1;

  float left_tap = left;
  float right_tap = right;
  if (p.fold_cols) {
    // zero-flux mirror ghosts folded into the lateral taps
    if (last) left_tap = left * 2.0f;
    if (first) right_tap = right * 2.0f;
  }
  float lap;
  if (p.square[s]) {
    lap = (((above + below) + left_tap) + right_tap) * p.a0[s] +
          c * p.a_center[s];
  } else {
    lap = ((above + below) * p.a0[s] + (left_tap + right_tap) * p.a1[s]) +
          c * p.a_center[s];
  }
  if (top && grm[gj]) {
    lap = lap + (below - p.two_dx0 * grv[gj]) * p.a0[s];
  }
  if (bottom && grm[w + gj]) {
    lap = lap + (above + p.two_dx0 * grv[w + gj]) * p.a0[s];
  }
  if (!p.fold_cols) {
    if (first && gcm[gi]) {
      lap = lap + (right - p.two_dx1 * gcv[gi]) * p.a1[s];
    }
    if (last && gcm[h + gi]) {
      lap = lap + (left + p.two_dx1 * gcv[h + gi]) * p.a1[s];
    }
  }
  float update = lap;
  if (HAS_CONVECTION) {
    float gradient0 = (below - above) * p.cv0[s];
    if (top && grm[gj]) gradient0 = p.flux0[s] * grv[gj];
    if (bottom && grm[w + gj]) gradient0 = p.flux0[s] * grv[w + gj];
    float gradient1 = (right - left) * p.cv1[s];
    if (p.fold_cols) {
      if (first || last) gradient1 = gradient1 * 0.0f;
    } else {
      if (first && gcm[gi]) gradient1 = p.flux1[s] * gcv[gi];
      if (last && gcm[h + gi]) gradient1 = p.flux1[s] * gcv[h + gi];
    }
    update = (update + gradient0) + gradient1;
  }
  float next = y + update;
  // the Dirichlet stamp: rows, then columns
  if (top && drm[gj]) next = drv[gj];
  if (bottom && drm[w + gj]) next = drv[w + gj];
  if (first && dcm[gi]) next = dcv[gi];
  if (last && dcm[h + gi]) next = dcv[h + gi];
  return next;
}

// The same stage at a cell that lies on no face of the grid: no boundary
// term applies, so this is horner_stage with every face test false, the
// same operations in the same order.
template <bool HAS_CONVECTION>
__device__ __forceinline__ float interior_stage(const Problem& p, int s,
                                                float y, float c,
                                                float above, float below,
                                                float left, float right) {
  float update;
  if (p.square[s]) {
    update = (((above + below) + left) + right) * p.a0[s] + c * p.a_center[s];
  } else {
    update = ((above + below) * p.a0[s] + (left + right) * p.a1[s]) +
             c * p.a_center[s];
  }
  if (HAS_CONVECTION) {
    const float gradient0 = (below - above) * p.cv0[s];
    const float gradient1 = (right - left) * p.cv1[s];
    update = (update + gradient0) + gradient1;
  }
  return y + update;
}

// One RK4 step of a shared-memory tile of rows x cols cells whose cell
// (0, 0) is grid cell (gi0, gj0). `y` holds the step's initial state,
// valid from `margin` cells inside the tile's edge; the result is
// written to `tb`, valid from margin + 4, and `ta` is scratch.
// Out-of-grid cells are written as zero. Ends with a block barrier.
// Cells off the faces, nearly all of them, take interior_stage; the face
// tests of horner_stage are paid only on the faces. With INTERIOR the
// dense Dirichlet grid then overrides every constrained cell (the face
// stamps agree with it where both apply), which is where the whole-grid
// kernel K1 applies its grid, after each stage's update.
template <bool HAS_CONVECTION, bool INTERIOR>
__device__ __forceinline__ void rk4_step_in_tile(const Problem& p,
                                                 const float* y, float* ta,
                                                 float* tb, int rows,
                                                 int cols, int gi0, int gj0,
                                                 int margin) {
  const float* in = y;
  float* out = ta;
  const unsigned inner_rows = static_cast<unsigned>(p.height - 2);
  const unsigned inner_cols = static_cast<unsigned>(p.width - 2);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int m = margin + s + 1;
    for (int li = m + threadIdx.y; li < rows - m; li += blockDim.y) {
      const int gi = gi0 + li;
      const bool row_in_grid = gi >= 0 && gi < p.height;
      // 1 <= gi <= height - 2, as one unsigned comparison
      const bool row_inside = static_cast<unsigned>(gi - 1) < inner_rows;
      for (int lj = m + threadIdx.x; lj < cols - m; lj += blockDim.x) {
        const int gj = gj0 + lj;
        const int idx = li * cols + lj;
        float value = 0.0f;
        bool in_grid = true;
        if (row_inside && static_cast<unsigned>(gj - 1) < inner_cols) {
          value = interior_stage<HAS_CONVECTION>(
              p, s, y[idx], in[idx], in[idx - cols], in[idx + cols],
              in[idx - 1], in[idx + 1]);
        } else if (row_in_grid && gj >= 0 && gj < p.width) {
          value = horner_stage<HAS_CONVECTION>(
              p, s, gi, gj, y[idx], in[idx], in[idx - cols], in[idx + cols],
              in[idx - 1], in[idx + 1]);
        } else {
          in_grid = false;
        }
        if constexpr (INTERIOR) {
          if (in_grid) {
            const size_t cell = static_cast<size_t>(gi) * p.width + gj;
            if (__ldg(p.interior_mask + cell)) {
              value = __ldg(p.interior_vals + cell);
            }
          }
        }
        out[idx] = value;
      }
    }
    __syncthreads();
    in = out;
    out = (out == ta) ? tb : ta;
  }
}

struct TiledLaunch {
  int smem_rows;
  int smem_cols;
  int halo;        // 4 * k_steps
  int k_steps;     // RK4 steps of this residency
  int source_kind;
  int traj_bfloat16;
  int state_bfloat16;
};

// K6, one residency: block (bx, by) advances its tile k_steps steps from
// `source` and writes its part of frames first_frame .. first_frame +
// k_steps - 1 of `traj` ((n_steps, H, W)) and, when `state_out` is not
// null, of the carried state.
template <bool HAS_CONVECTION>
__global__ void __launch_bounds__(512, 2)
    tiled_diffusion_kernel(Problem p, TiledLaunch t,
                           const void* __restrict__ source,
                           void* __restrict__ traj, size_t first_frame,
                           void* __restrict__ state_out) {
  extern __shared__ __align__(16) float shared[];
  const int rows = t.smem_rows;
  const int cols = t.smem_cols;
  const int halo = t.halo;
  const int tile_h = rows - 2 * halo;
  const int tile_w = cols - 2 * halo;
  float* y = shared;
  float* ta = y + rows * cols;
  float* tb = ta + rows * cols;
  const int gi0 = static_cast<int>(blockIdx.y) * tile_h - halo;
  const int gj0 = static_cast<int>(blockIdx.x) * tile_w - halo;
  const size_t cells = static_cast<size_t>(p.height) * p.width;

  for (int li = threadIdx.y; li < rows; li += blockDim.y) {
    const int gi = gi0 + li;
    const bool row_in_grid = gi >= 0 && gi < p.height;
    for (int lj = threadIdx.x; lj < cols; lj += blockDim.x) {
      const int gj = gj0 + lj;
      float value = 0.0f;
      if (row_in_grid && gj >= 0 && gj < p.width) {
        value = load_state(source, t.source_kind,
                           static_cast<size_t>(gi) * p.width + gj);
      }
      y[li * cols + lj] = value;
    }
  }
  __syncthreads();

  for (int step = 0; step < t.k_steps; ++step) {
    rk4_step_in_tile<HAS_CONVECTION, false>(p, y, ta, tb, rows, cols, gi0,
                                            gj0, kStepHalo * step);
    // the step's result is in tb; the old y becomes scratch
    float* previous = y;
    y = tb;
    tb = ta;
    ta = previous;
    const size_t frame = (first_frame + step) * cells;
    const bool last_step = step + 1 == t.k_steps;
    for (int li = halo + threadIdx.y; li < halo + tile_h; li += blockDim.y) {
      const int gi = gi0 + li;
      if (gi >= p.height) break;
      for (int lj = halo + threadIdx.x; lj < halo + tile_w;
           lj += blockDim.x) {
        const int gj = gj0 + lj;
        if (gj >= p.width) break;
        const float value = y[li * cols + lj];
        const size_t cell = static_cast<size_t>(gi) * p.width + gj;
        store_state(traj, t.traj_bfloat16, frame + cell, value);
        if (last_step && state_out != nullptr) {
          store_state(state_out, t.state_bfloat16, cell, value);
        }
      }
    }
    // no barrier is needed here: the next stage writes the old y, which
    // no thread reads any more, and reads the new y, which the step's
    // last barrier completed
  }
}

struct ResidentLaunch {
  int n_tiles_w;
  int tile_h;
  int tile_w;
  int n_steps;
  int traj_bfloat16;
  int steps_per_barrier;
};

// K7: block b keeps tile (b / n_tiles_w, b % n_tiles_w) of the state in
// shared memory for all n_steps, with a halo of 4 * steps_per_barrier
// cells. WRITE_TRAJECTORY: it writes frame k of `out` ((n_steps, H, W))
// after step k; otherwise (the end mode) it writes its tile of `out`
// ((H, W) float32) once, after the last step. After every
// steps_per_barrier steps it exchanges halos with its neighbours through
// `exchange` ((2, H, W) floats) around one grid-wide barrier. Between
// barriers the halo is recomputed, shrinking by 4 cells a step, as in the
// tiled kernel. INTERIOR: the dense Dirichlet grid applies after every
// stage (rk4_step_in_tile).
template <bool HAS_CONVECTION, bool INTERIOR, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(1024, 1)
    resident_diffusion_kernel(Problem p, ResidentLaunch t,
                              const float* __restrict__ y0, void* out,
                              float* exchange) {
  extern __shared__ __align__(16) float shared[];
  cg::grid_group grid = cg::this_grid();
  const int halo = kStepHalo * t.steps_per_barrier;
  const int rows = t.tile_h + 2 * halo;
  const int cols = t.tile_w + 2 * halo;
  float* y = shared;
  float* ta = y + rows * cols;
  float* tb = ta + rows * cols;
  const int tile_i = static_cast<int>(blockIdx.x) / t.n_tiles_w;
  const int tile_j = static_cast<int>(blockIdx.x) % t.n_tiles_w;
  const int gi0 = tile_i * t.tile_h - halo;
  const int gj0 = tile_j * t.tile_w - halo;
  const size_t cells = static_cast<size_t>(p.height) * p.width;

  for (int li = threadIdx.y; li < rows; li += blockDim.y) {
    const int gi = gi0 + li;
    const bool row_in_grid = gi >= 0 && gi < p.height;
    for (int lj = threadIdx.x; lj < cols; lj += blockDim.x) {
      const int gj = gj0 + lj;
      float value = 0.0f;
      if (row_in_grid && gj >= 0 && gj < p.width) {
        value = y0[static_cast<size_t>(gi) * p.width + gj];
      }
      y[li * cols + lj] = value;
    }
  }
  __syncthreads();

  int k = 0;
  for (int group = 0; k < t.n_steps; ++group) {
    float* published = exchange + static_cast<size_t>(group & 1) * cells;
    for (int g = 0; g < t.steps_per_barrier && k < t.n_steps; ++g, ++k) {
      rk4_step_in_tile<HAS_CONVECTION, INTERIOR>(p, y, ta, tb, rows, cols,
                                                 gi0, gj0, kStepHalo * g);
      float* previous = y;
      y = tb;
      tb = ta;
      ta = previous;
      // the tile proper of the new state is complete: store the frame
      // (the end mode: the last step's state) and, before a barrier,
      // publish the cells within `halo` of the tile's edge
      const size_t frame =
          WRITE_TRAJECTORY ? static_cast<size_t>(k) * cells : 0;
      const bool store = WRITE_TRAJECTORY || k + 1 == t.n_steps;
      const bool publish =
          g + 1 == t.steps_per_barrier && k + 1 < t.n_steps;
      for (int li = halo + threadIdx.y; li < halo + t.tile_h;
           li += blockDim.y) {
        const int gi = gi0 + li;
        if (gi >= p.height) break;
        const bool edge_row = li < 2 * halo || li >= t.tile_h;
        for (int lj = halo + threadIdx.x; lj < halo + t.tile_w;
             lj += blockDim.x) {
          const int gj = gj0 + lj;
          if (gj >= p.width) break;
          const float value = y[li * cols + lj];
          const size_t cell = static_cast<size_t>(gi) * p.width + gj;
          if (store) store_state(out, t.traj_bfloat16, frame + cell, value);
          if (publish && (edge_row || lj < 2 * halo || lj >= t.tile_w)) {
            __stcg(published + cell, value);
          }
        }
      }
    }
    if (k >= t.n_steps) break;
    __threadfence();
    grid.sync();
    // the halo ring from the neighbours' published cells (zero outside
    // the grid); loads bypass the L1 cache, which other SMs' stores do
    // not reach
    for (int li = threadIdx.y; li < rows; li += blockDim.y) {
      const int gi = gi0 + li;
      const bool row_in_grid = gi >= 0 && gi < p.height;
      const bool ring_row = li < halo || li >= halo + t.tile_h;
      for (int lj = threadIdx.x; lj < cols; lj += blockDim.x) {
        if (!(ring_row || lj < halo || lj >= halo + t.tile_w)) continue;
        const int gj = gj0 + lj;
        float value = 0.0f;
        if (row_in_grid && gj >= 0 && gj < p.width) {
          value = __ldcg(published + static_cast<size_t>(gi) * p.width + gj);
        }
        y[li * cols + lj] = value;
      }
    }
    __syncthreads();
  }
}

// Fills the problem description from the host's coefficient array:
// 4 x (a0, a1, a_center, cv0, cv1, flux0, flux1), two_dx0, two_dx1.
Problem make_problem(int height, int width, int fold_cols, int square_bits,
                     const float* coefficients, const uint8_t* masks,
                     const float* values) {
  Problem p;
  p.height = height;
  p.width = width;
  p.fold_cols = fold_cols;
  for (int s = 0; s < kStages; ++s) {
    const float* stage = coefficients + 7 * s;
    p.square[s] = (square_bits >> s) & 1;
    p.a0[s] = stage[0];
    p.a1[s] = stage[1];
    p.a_center[s] = stage[2];
    p.cv0[s] = stage[3];
    p.cv1[s] = stage[4];
    p.flux0[s] = stage[5];
    p.flux1[s] = stage[6];
  }
  p.two_dx0 = coefficients[7 * kStages];
  p.two_dx1 = coefficients[7 * kStages + 1];
  p.masks = masks;
  p.values = values;
  p.interior_mask = nullptr;
  p.interior_vals = nullptr;
  return p;
}

template <bool HAS_CONVECTION, bool INTERIOR>
const void* resident_kernel(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   resident_diffusion_kernel<HAS_CONVECTION, INTERIOR, true>)
             : reinterpret_cast<const void*>(
                   resident_diffusion_kernel<HAS_CONVECTION, INTERIOR,
                                             false>);
}

cudaError_t allow_shared_memory(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* tiled_diffusion_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// K6: n_steps / temporal_block launches on `stream`, each advancing every
// tile temporal_block steps. y0 is (H, W) float32; traj is (n_steps, H, W)
// float32 or bfloat16; state_a and state_b are two (H, W) buffers of the
// carried state's type, or null when the frames have that type and carry
// the state. Returns the cudaError_t of the first failed call (0 on
// success); the caller raises on anything else.
int tiled_diffusion_rk4(const float* y0, void* traj, void* state_a,
                        void* state_b, int height, int width, int n_steps,
                        int temporal_block, int storage_bfloat16,
                        int traj_bfloat16, int smem_rows, int smem_cols,
                        int has_convection, int fold_cols, int square_bits,
                        const float* coefficients, const uint8_t* masks,
                        const float* values, void* stream) {
  const int halo = kStepHalo * temporal_block;
  const int tile_h = smem_rows - 2 * halo;
  const int tile_w = smem_cols - 2 * halo;
  if (height < 3 || width < 3 || n_steps <= 0 || temporal_block <= 0 ||
      n_steps % temporal_block != 0 || tile_h <= 0 || tile_w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool separate_state = storage_bfloat16 != traj_bfloat16;
  if (separate_state && (state_a == nullptr || state_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p = make_problem(height, width, fold_cols, square_bits,
                                 coefficients, masks, values);
  const void* kernel =
      has_convection
          ? reinterpret_cast<const void*>(tiled_diffusion_kernel<true>)
          : reinterpret_cast<const void*>(tiled_diffusion_kernel<false>);
  const size_t shared_bytes =
      3 * sizeof(float) * static_cast<size_t>(smem_rows) * smem_cols;
  cudaError_t error = allow_shared_memory(kernel, shared_bytes);
  if (error != cudaSuccess) return static_cast<int>(error);

  const dim3 blocks((width + tile_w - 1) / tile_w,
                    (height + tile_h - 1) / tile_h);
  const dim3 threads(32, 16);
  const size_t cells = static_cast<size_t>(height) * width;
  const size_t traj_item = traj_bfloat16 ? 2 : 4;
  void* states[2] = {state_a, state_b};
  const int residencies = n_steps / temporal_block;
  for (int m = 0; m < residencies; ++m) {
    TiledLaunch t;
    t.smem_rows = smem_rows;
    t.smem_cols = smem_cols;
    t.halo = halo;
    t.k_steps = temporal_block;
    t.traj_bfloat16 = traj_bfloat16;
    t.state_bfloat16 = storage_bfloat16;
    const void* source;
    if (m == 0) {
      // the initial state rounds to the carried state's type
      source = y0;
      t.source_kind = storage_bfloat16 ? kSourceFloatRounded : kSourceFloat;
    } else {
      t.source_kind = storage_bfloat16 ? kSourceBfloat16 : kSourceFloat;
      if (separate_state) {
        source = states[m % 2];
      } else {
        // the previous residency's last frame is the carried state
        source = static_cast<const char*>(traj) +
                 (static_cast<size_t>(m) * temporal_block - 1) * cells *
                     traj_item;
      }
    }
    void* state_out = (separate_state && m + 1 < residencies)
                          ? states[(m + 1) % 2]
                          : nullptr;
    size_t first_frame = static_cast<size_t>(m) * temporal_block;
    void* args[] = {const_cast<Problem*>(&p), &t, &source, &traj,
                    &first_frame, &state_out};
    error = cudaLaunchKernel(kernel, blocks, threads, args, shared_bytes,
                             static_cast<cudaStream_t>(stream));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: one cooperative launch on `stream` of n_tiles_h x n_tiles_w blocks
// that pass one grid-wide barrier every steps_per_barrier steps. y0 is
// (H, W) float32; with write_trajectory, out is (n_steps, H, W) float32
// or bfloat16 (traj_bfloat16), else (the end mode) the (H, W) float32 end
// state; exchange is (2, H, W) float32 scratch. interior_mask and
// interior_vals are the dense (H, W) Dirichlet grid where constraints lie
// inside the grid, else both null. Returns
// cudaErrorCooperativeLaunchTooLarge, without launching, when the card
// cannot hold all blocks at once, else the cudaError_t of the launch.
int resident_diffusion_rk4(const float* y0, void* out, float* exchange,
                           int height, int width, int n_steps,
                           int write_trajectory, int traj_bfloat16,
                           int n_tiles_h, int n_tiles_w, int tile_h,
                           int tile_w, int steps_per_barrier,
                           int has_convection, int fold_cols,
                           int square_bits,
                           const float* coefficients, const uint8_t* masks,
                           const float* values,
                           const uint8_t* interior_mask,
                           const float* interior_vals, void* stream) {
  if ((interior_mask == nullptr) != (interior_vals == nullptr) ||
      (traj_bfloat16 && !write_trajectory)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (height < 3 || width < 3 || n_steps <= 0 || tile_h <= 0 ||
      tile_w <= 0 || n_tiles_h <= 0 || n_tiles_w <= 0 ||
      steps_per_barrier <= 0 ||
      static_cast<long long>(n_tiles_h) * tile_h < height ||
      static_cast<long long>(n_tiles_w) * tile_w < width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Problem p = make_problem(height, width, fold_cols, square_bits,
                           coefficients, masks, values);
  p.interior_mask = interior_mask;
  p.interior_vals = interior_vals;
  const bool interior = interior_mask != nullptr;
  const void* kernel =
      has_convection
          ? (interior ? resident_kernel<true, true>(write_trajectory)
                      : resident_kernel<true, false>(write_trajectory))
          : (interior ? resident_kernel<false, true>(write_trajectory)
                      : resident_kernel<false, false>(write_trajectory));
  const int halo = kStepHalo * steps_per_barrier;
  const size_t shared_bytes = 3 * sizeof(float) *
                              static_cast<size_t>(tile_h + 2 * halo) *
                              (tile_w + 2 * halo);
  cudaError_t error = allow_shared_memory(kernel, shared_bytes);
  if (error != cudaSuccess) return static_cast<int>(error);

  // 32 x 32 threads for tiles of many rows, fewer rows of threads for low
  // tiles so that no warp idles through every stage
  int thread_rows = tile_h + 2 * halo;
  if (thread_rows > 32) thread_rows = 32;
  const dim3 threads(32, thread_rows);
  const int n_threads = 32 * thread_rows;

  int device = 0;
  error = cudaGetDevice(&device);
  if (error != cudaSuccess) return static_cast<int>(error);
  int sm_count = 0;
  error = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
  if (error != cudaSuccess) return static_cast<int>(error);
  int cooperative = 0;
  error = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                                 device);
  if (error != cudaSuccess) return static_cast<int>(error);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  int blocks_per_sm = 0;
  error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks_per_sm, kernel, n_threads, shared_bytes);
  if (error != cudaSuccess) return static_cast<int>(error);
  const int n_blocks = n_tiles_h * n_tiles_w;
  if (n_blocks > blocks_per_sm * sm_count) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }

  ResidentLaunch t;
  t.n_tiles_w = n_tiles_w;
  t.tile_h = tile_h;
  t.tile_w = tile_w;
  t.n_steps = n_steps;
  t.traj_bfloat16 = traj_bfloat16;
  t.steps_per_barrier = steps_per_barrier;
  void* args[] = {&p, &t, &y0, &out, &exchange};
  error = cudaLaunchCooperativeKernel(kernel, dim3(n_blocks), threads, args,
                                      shared_bytes,
                                      static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
