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
// JAX package's polar branch; K4 is Cartesian only, as in the JAX package)
// and on whether every step is stored. It computes what the JAX package's step
// factories compute over its _StencilHelpers, term for term and in the
// same order. For the wave, Burgers and shallow-water systems, classic RK4:
//   k1 = f(y), k2 = f(D(y + (d_t/2) k1)), k3 = f(D(y + (d_t/2) k2)),
//   k4 = f(D(y + d_t k3)), y' = D(y + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
// with D the per-component Dirichlet override; for Cahn-Hilliard its own
// two-stage step (system_2d.cuh). The Laplacian adds each axis's Neumann
// ghost term to that axis's second derivative before summing them.
//
// What bounds it on the card: neither bytes nor FLOPs. The main paths'
// grids are 21 x 21 x 2 and 41 x 41 x 2 (3.5 and 13 KB of state) and one
// RK4 step is 35 to 279 FLOPs a cell, so each step is a chain of
// dependent stages, each a few shared-memory loads, some arithmetic and a
// block-wide barrier, on one SM. On an NVIDIA H100 80GB HBM3 (700 W)
// this kernel measured 5.04 us a Burgers step at 21 x 21 (80,000 steps in
// 402.9 ms), where the card's FLOP rate would allow 1.2 ns.
//
// What the design does about it: one CTA owns one state for all n_steps,
// so the chain never leaves the SM. The component planes, two stage
// buffers, the RK4 accumulator, the Dirichlet grids and the Neumann face
// vectors live in shared memory for the whole solve (5n + ~1 float
// planes), a __syncthreads() separates the stages, and the only
// device-memory traffic is the initial read plus either the step's frame
// (trajectory; stored from the last stage, each thread writing its
// cell's n consecutive values, in the JAX package's (..., H, W, n)
// layout, in float32 or, for K4's snapshot dtype, rounded to bfloat16
// over the float32 carried state) or the end state. A polar grid keeps
// its H values of 1 / r in shared memory too. A batch of states is the grid: one CTA per
// state, so K4's 100 Parareal slices run side by side on 100 of the 132
// SMs. The TPU kernels' (8, 128) padding, lane packing of the slices and
// DMA double-buffering are not carried over. A grid fits when its working
// set (ops/fused_system.py shared_memory_bytes, which the host passes to
// the launch) is at most the 227 KB a block can opt into: about 74 x 74
// for two components, 60 x 60 for three. Larger grids take K8. Making it
// fast (warp-level stages, registers instead of shared memory, several
// states per CTA) is later work.
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

// Where a step's frame goes: from element `offset` of `data`, float32
// or bfloat16.
struct Frame {
  void* data;
  size_t offset;
  int bfloat16;
};

// The shared-memory buffers of one CTA, each n planes of `cells` values.
struct Buffers {
  float* state;
  float* stage_a;
  float* stage_b;
  float* acc;
  const float* dir_vals;
  const uint8_t* dir_mask;
};

__device__ __forceinline__ Cell make_cell(int c, const Params& p) {
  Cell x;
  x.i = c / p.width;
  x.j = c - x.i * p.width;
  x.idx = c;
  return x;
}

// Stage STAGE (0-3) of an RK4 step, reading `in` and writing the
// accumulator and `next` (STAGE < 3) or the state and the step's frame
// (STAGE == 3).
template <class Equation, class Grid, int STAGE, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void rk4_stage(const Planes& in, float* next,
                                          const Buffers& bf,
                                          const Params& p, const Faces& f,
                                          const Frame& frame) {
  constexpr int N = Equation::kComponents;
  const int cells = in.stride;
  float k[N];
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const Cell x = make_cell(c, p);
    Equation::template rhs<Grid>(in, x, p, f, k);
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      const int e = comp * cells + c;
      const bool fixed = bf.dir_mask[e] != 0;
      if constexpr (STAGE == 0) {
        bf.acc[e] = k[comp];
        next[e] = fixed ? bf.dir_vals[e] : bf.state[e] + p.half_d_t * k[comp];
      } else if constexpr (STAGE == 1) {
        bf.acc[e] = bf.acc[e] + 2.0f * k[comp];
        next[e] = fixed ? bf.dir_vals[e] : bf.state[e] + p.half_d_t * k[comp];
      } else if constexpr (STAGE == 2) {
        bf.acc[e] = bf.acc[e] + 2.0f * k[comp];
        next[e] = fixed ? bf.dir_vals[e] : bf.state[e] + p.d_t * k[comp];
      } else {
        // each thread rewrites only its own cell of the state, which no
        // other thread reads in this stage
        const float value =
            fixed ? bf.dir_vals[e]
                  : bf.state[e] + p.sixth_d_t * (bf.acc[e] + k[comp]);
        bf.state[e] = value;
        if constexpr (WRITE_TRAJECTORY) {
          store_state(frame.data, frame.bfloat16,
                      frame.offset + static_cast<size_t>(c) * N + comp,
                      value);
        }
      }
    }
  }
}

// One Cahn-Hilliard step: the first stage reads the state and stores k1
// and D1(potential) in the accumulator and D1(y1) in stage_a; the second
// reads stage_a's component 1. A block barrier follows each.
template <class Grid, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void cahn_hilliard_step(const Planes& state_in,
                                                   const Planes& stage_in,
                                                   const Buffers& bf,
                                                   const Params& p,
                                                   const Faces& f,
                                                   const Frame& frame) {
  constexpr int N = CahnHilliard2D::kComponents;
  const int cells = state_in.stride;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const Cell x = make_cell(c, p);
    float k1, potential;
    CahnHilliard2D::first<Grid>(state_in, x, p, f, &k1, &potential);
    const int e1 = cells + c;
    const bool fixed1 = bf.dir_mask[e1] != 0;
    bf.acc[c] = k1;
    bf.acc[e1] = fixed1 ? bf.dir_vals[e1] : potential;
    bf.stage_a[e1] = fixed1 ? bf.dir_vals[e1] : bf.state[e1];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const Cell x = make_cell(c, p);
    const float rest = CahnHilliard2D::k_rest<Grid>(stage_in, x, p, f);
    const float combined = bf.acc[c] + 5.0f * rest;
    const float y0 = bf.dir_mask[c] ? bf.dir_vals[c]
                                    : bf.state[c] + p.sixth_d_t * combined;
    const float y1 = bf.acc[cells + c];
    bf.state[c] = y0;
    bf.state[cells + c] = y1;
    if constexpr (WRITE_TRAJECTORY) {
      const size_t cell = frame.offset + static_cast<size_t>(c) * N;
      store_state(frame.data, frame.bfloat16, cell, y0);
      store_state(frame.data, frame.bfloat16, cell + 1, y1);
    }
  }
  __syncthreads();
}

// One CTA advances state blockIdx.x of `y0` ((B, H, W, n), row-major) by
// n_steps steps. WRITE_TRAJECTORY: out is (B, n_steps, H, W, n), float32
// or bfloat16 (frame_bfloat16), and receives every step; otherwise out is
// (B, H, W, n) float32 and receives the end. The constant tensors are the
// Dirichlet grids (n, H, W), the Neumann face vectors described in
// system_2d.cuh and, for a polar grid, the H values of 1 / r. One block a
// multiprocessor is asked for: with the block size alone, ptxas caps some
// instances at 32 registers and spills (the Burgers trajectory ran 7-9%
// slower so on an NVIDIA H100 80GB HBM3 at 700 W); a state is one block
// and the batches are at most a few hundred states, so the second block a
// multiprocessor that the cap would allow buys nothing.
template <class Equation, class Grid, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(1024, 1)
    fused_system_rk4_kernel(const float* __restrict__ y0,
                            void* __restrict__ out, Params p, int n_steps,
                            int frame_bfloat16,
                            const uint8_t* __restrict__ dir_mask_in,
                            const float* __restrict__ dir_vals_in,
                            const uint8_t* __restrict__ grm_in,
                            const float* __restrict__ grv_in,
                            const uint8_t* __restrict__ gcm_in,
                            const float* __restrict__ gcv_in,
                            const float* __restrict__ inv_r_in) {
  constexpr int N = Equation::kComponents;
  extern __shared__ __align__(16) float shared[];
  const int h = p.height;
  const int w = p.width;
  const int cells = h * w;
  const int values = N * cells;
  // layout (sized by ops/fused_system.py shared_memory_bytes): five sets
  // of n float planes, the float face vectors, 1 / r by row on a polar
  // grid, then the byte masks
  float* state = shared;
  float* stage_a = state + values;
  float* stage_b = stage_a + values;
  float* acc = stage_b + values;
  float* dir_vals = acc + values;
  float* grv = dir_vals + values;
  float* gcv = grv + 2 * N * w;
  float* inv_r = gcv + 2 * N * h;
  uint8_t* dir_mask =
      reinterpret_cast<uint8_t*>(inv_r + (Grid::kPolar ? h : 0));
  uint8_t* grm = dir_mask + values;
  uint8_t* gcm = grm + 2 * N * w;

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  // the state arrives interleaved ((H, W, n)) and is kept as planes
  const float* y_in = y0 + b * values;
  for (int e = tid; e < values; e += stride) {
    const int cell = e / N;
    state[(e - cell * N) * cells + cell] = y_in[e];
    dir_vals[e] = dir_vals_in[e];
    dir_mask[e] = dir_mask_in[e];
  }
  for (int e = tid; e < 2 * N * w; e += stride) {
    grv[e] = grv_in[e];
    grm[e] = grm_in[e];
  }
  for (int e = tid; e < 2 * N * h; e += stride) {
    gcv[e] = gcv_in[e];
    gcm[e] = gcm_in[e];
  }
  if constexpr (Grid::kPolar) {
    for (int e = tid; e < h; e += stride) inv_r[e] = inv_r_in[e];
  }
  __syncthreads();

  const Faces faces = {grm, grv, gcm, gcv, N, inv_r};
  const Buffers bf = {state, stage_a, stage_b, acc, dir_vals, dir_mask};
  const Planes state_in = {state, cells, w};
  const Planes stage_a_in = {stage_a, cells, w};
  const Planes stage_b_in = {stage_b, cells, w};
  for (int step = 0; step < n_steps; ++step) {
    const Frame frame = {out, (b * n_steps + step) * values,
                         frame_bfloat16};
    if constexpr (Equation::kRK4) {
      rk4_stage<Equation, Grid, 0, WRITE_TRAJECTORY>(state_in, stage_a, bf,
                                                     p, faces, frame);
      __syncthreads();
      rk4_stage<Equation, Grid, 1, WRITE_TRAJECTORY>(stage_a_in, stage_b,
                                                     bf, p, faces, frame);
      __syncthreads();
      rk4_stage<Equation, Grid, 2, WRITE_TRAJECTORY>(stage_b_in, stage_a,
                                                     bf, p, faces, frame);
      __syncthreads();
      rk4_stage<Equation, Grid, 3, WRITE_TRAJECTORY>(stage_a_in, nullptr,
                                                     bf, p, faces, frame);
      __syncthreads();
    } else {
      cahn_hilliard_step<Grid, WRITE_TRAJECTORY>(state_in, stage_a_in, bf,
                                                 p, faces, frame);
    }
  }
  if (!WRITE_TRAJECTORY) {
    float* y_out = static_cast<float*>(out) + b * values;
    for (int e = tid; e < values; e += stride) {
      const int cell = e / N;
      y_out[e] = state[(e - cell * N) * cells + cell];
    }
  }
}

template <class Equation, class Grid>
void* select_kernel(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<void*>(
                   fused_system_rk4_kernel<Equation, Grid, true>)
             : reinterpret_cast<void*>(
                   fused_system_rk4_kernel<Equation, Grid, false>);
}

template <class Equation>
void* select_kernel(int polar, int write_trajectory) {
  return polar ? select_kernel<Equation, PolarWholeGrid>(write_trajectory)
               : select_kernel<Equation, WholeGrid>(write_trajectory);
}

}  // namespace

extern "C" {

const char* fused_system_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// Launches one CTA per state of y0 ((batch, H, W, n) float32, contiguous)
// on `stream` for the equation `equation` (system_2d.cuh EquationId) on a
// Cartesian or (polar != 0, with the H values of 1 / r in inv_r) a polar
// grid, with `shared_bytes` of dynamic shared memory, the host's count of
// the layout the kernel carves. A trajectory's frames are float32 or
// (frame_bfloat16) bfloat16. `coefficients` holds the kCoefficients floats
// of system_2d.cuh make_params. Returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.
int fused_system_rk4(int equation, int polar, const float* y0, void* out,
                     int batch, int height, int width, int n_steps,
                     int write_trajectory, int frame_bfloat16,
                     size_t shared_bytes, const uint8_t* dir_mask,
                     const float* dir_vals, const uint8_t* ghost_row_mask,
                     const float* ghost_row_vals,
                     const uint8_t* ghost_col_mask,
                     const float* ghost_col_vals, const float* inv_r,
                     const float* coefficients, void* stream) {
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3 ||
      (polar && inv_r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = nullptr;
  switch (equation) {
    case kWave2D:
      kernel = select_kernel<Wave2D>(polar, write_trajectory);
      break;
    case kBurgers2D:
      kernel = select_kernel<Burgers2D>(polar, write_trajectory);
      break;
    case kShallowWater2D:
      kernel = select_kernel<ShallowWater2D>(polar, write_trajectory);
      break;
    case kCahnHilliard2D:
      kernel = select_kernel<CahnHilliard2D>(polar, write_trajectory);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(height, width, coefficients);
  const int cells = height * width;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;

  if (shared_bytes > 48 * 1024) {
    cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  void* args[] = {&y0,
                  &out,
                  const_cast<Params*>(&p),
                  &n_steps,
                  &frame_bfloat16,
                  &dir_mask,
                  &dir_vals,
                  &ghost_row_mask,
                  &ghost_row_vals,
                  &ghost_col_mask,
                  &ghost_col_vals,
                  &inv_r};
  cudaError_t error =
      cudaLaunchKernel(kernel, dim3(batch), dim3(threads), args,
                       shared_bytes, static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
