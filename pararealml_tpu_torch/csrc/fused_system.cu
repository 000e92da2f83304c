// Fused RK4 kernels for multi-component 2D Cartesian systems with static
// boundary conditions, for Hopper (sm_90a). Burgers is the one equation
// ported so far.
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
// equation functor (Burgers2D) and on whether every step is stored. It
// computes what the JAX package's RK4 step factory computes over its
// _StencilHelpers, term for term and in the same order:
//   k1 = f(y), k2 = f(D(y + (d_t/2) k1)), k3 = f(D(y + (d_t/2) k2)),
//   k4 = f(D(y + d_t k3)), y' = D(y + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
// with D the per-component Dirichlet override, and for Burgers
//   f_c(y) = nu lap(y_c) - y_0 d0(y_c) - y_1 d1(y_c),
// where lap adds the axis-0 Neumann ghost-row correction to the axis-0
// second derivative and the ghost-column correction to the axis-1 one
// before summing them, and d0/d1 are central differences with zero
// halos whose boundary values are replaced by the constrained normal
// derivative where a face has one.
//
// What bounds it on the card: neither bytes nor FLOPs. The main path's
// grid is 21 x 21 x 2 (882 values, 3.5 KB of state) and one RK4 step is
// about 180 FLOPs a cell, so each step is a chain of four dependent
// stages, each a few shared-memory loads, some arithmetic and a
// block-wide barrier, on one SM. On an NVIDIA H100 80GB HBM3 (700 W)
// this kernel measured 5.04 us a step at 21 x 21 (80,000 steps in
// 402.9 ms), where the card's FLOP rate would allow 1.2 ns.
//
// What the design does about it: one CTA owns one state for all n_steps,
// so the chain never leaves the SM. The component planes, two stage
// buffers, the RK4 accumulator, the Dirichlet grids and the Neumann face
// vectors live in shared memory for the whole solve (5n + ~1 float
// planes), a __syncthreads() separates the four stages, and the only
// device-memory traffic is the initial read plus either the step's frame
// (trajectory; stored from the last stage, each thread writing its
// cell's n consecutive values, in the JAX package's (..., H, W, n)
// layout) or the end state. A batch of states is the grid: one CTA per
// state, so K4's 100 Parareal slices run side by side on 100 of the 132
// SMs. The TPU kernels' (8, 128) padding, lane packing of the slices and
// DMA double-buffering are not carried over. A grid fits when
// fused_system_shared_bytes is at most the 227 KB a block can opt into
// (about 74 x 74 for Burgers). Making it fast (warp-level stages,
// registers instead of shared memory, several states per CTA) is later
// work.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

struct Params {
  int height;
  int width;
  int n_steps;
  float half_d_t;
  float d_t;
  float sixth_d_t;
  // the equation's coefficient (Burgers: the viscosity 1 / Re)
  float coefficient;
  float inv_dx0_sqr;
  float inv_dx1_sqr;
  float inv_two_dx0;
  float inv_two_dx1;
  float two_dx0;
  float two_dx1;
};

// The Neumann face data in shared memory: ghost rows (grm/grv: 2 faces x
// n components x W, lower face first) and ghost columns (gcm/gcv: 2 x n
// x H), the layout of the JAX package's _component_constraint_tensors.
struct Faces {
  const uint8_t* grm;
  const float* grv;
  const uint8_t* gcm;
  const float* gcv;
  int n;
};

// One plane's value at a cell and its four neighbours, zero outside.
struct Neighbours {
  float centre;
  float above;
  float below;
  float left;
  float right;
};

__device__ __forceinline__ Neighbours neighbours(const float* plane, int i,
                                                 int j, int idx,
                                                 const Params& p) {
  const int w = p.width;
  Neighbours v;
  v.centre = plane[idx];
  v.above = i > 0 ? plane[idx - w] : 0.0f;
  v.below = i < p.height - 1 ? plane[idx + w] : 0.0f;
  v.left = j > 0 ? plane[idx - 1] : 0.0f;
  v.right = j < w - 1 ? plane[idx + 1] : 0.0f;
  return v;
}

// _StencilHelpers.laplacian (Cartesian) of component `comp`.
__device__ __forceinline__ float laplacian(const Neighbours& v, int comp,
                                           int i, int j, const Params& p,
                                           const Faces& f) {
  const int h = p.height;
  const int w = p.width;
  float d2_0 = (v.above - 2.0f * v.centre + v.below) * p.inv_dx0_sqr;
  if (i == 0) {
    const int face = comp * w + j;
    const float ghost = f.grm[face] ? v.below - p.two_dx0 * f.grv[face]
                                    : 0.0f;
    d2_0 = d2_0 + ghost * p.inv_dx0_sqr;
  } else if (i == h - 1) {
    const int face = (f.n + comp) * w + j;
    const float ghost = f.grm[face] ? v.above + p.two_dx0 * f.grv[face]
                                    : 0.0f;
    d2_0 = d2_0 + ghost * p.inv_dx0_sqr;
  }
  float d2_1 = (v.left - 2.0f * v.centre + v.right) * p.inv_dx1_sqr;
  if (j == 0) {
    const int face = comp * h + i;
    const float ghost = f.gcm[face] ? v.right - p.two_dx1 * f.gcv[face]
                                    : 0.0f;
    d2_1 = d2_1 + ghost * p.inv_dx1_sqr;
  } else if (j == w - 1) {
    const int face = (f.n + comp) * h + i;
    const float ghost = f.gcm[face] ? v.left + p.two_dx1 * f.gcv[face]
                                    : 0.0f;
    d2_1 = d2_1 + ghost * p.inv_dx1_sqr;
  }
  return d2_0 + d2_1;
}

// _StencilHelpers.gradient_0: the row derivative.
__device__ __forceinline__ float gradient_0(const Neighbours& v, int comp,
                                            int i, int j, const Params& p,
                                            const Faces& f) {
  float gradient = (v.below - v.above) * p.inv_two_dx0;
  if (i == 0) {
    const int face = comp * p.width + j;
    if (f.grm[face]) gradient = f.grv[face];
  } else if (i == p.height - 1) {
    const int face = (f.n + comp) * p.width + j;
    if (f.grm[face]) gradient = f.grv[face];
  }
  return gradient;
}

// _StencilHelpers.gradient_1 (Cartesian): the column derivative.
__device__ __forceinline__ float gradient_1(const Neighbours& v, int comp,
                                            int i, int j, const Params& p,
                                            const Faces& f) {
  float gradient = (v.right - v.left) * p.inv_two_dx1;
  if (j == 0) {
    const int face = comp * p.height + i;
    if (f.gcm[face]) gradient = f.gcv[face];
  } else if (j == p.width - 1) {
    const int face = (f.n + comp) * p.height + i;
    if (f.gcm[face]) gradient = f.gcv[face];
  }
  return gradient;
}

// The viscous Burgers system in 2D (the JAX package's
// _make_rhs_builder, BurgersEquation branch):
//   f_c = nu lap(y_c) - y_0 d0(y_c) - y_1 d1(y_c), c = 0, 1.
struct Burgers2D {
  static constexpr int kComponents = 2;

  // the right-hand side of every component at cell (i, j) of `planes`
  // (kComponents planes of `cells` values each)
  static __device__ __forceinline__ void rhs(const float* planes,
                                             int cells, int i, int j,
                                             int idx, const Params& p,
                                             const Faces& f, float* out) {
    const float y_0 = planes[idx];
    const float y_1 = planes[cells + idx];
#pragma unroll
    for (int comp = 0; comp < kComponents; ++comp) {
      const Neighbours v = neighbours(planes + comp * cells, i, j, idx, p);
      out[comp] = p.coefficient * laplacian(v, comp, i, j, p, f) -
                  y_0 * gradient_0(v, comp, i, j, p, f) -
                  y_1 * gradient_1(v, comp, i, j, p, f);
    }
  }
};

enum EquationId { kBurgers2D = 0 };

// One CTA advances state blockIdx.x of `y0` ((B, H, W, n), row-major) by
// n_steps RK4 steps. WRITE_TRAJECTORY: out is (B, n_steps, H, W, n) and
// receives every step; otherwise out is (B, H, W, n) and receives the
// end. The constant tensors are the Dirichlet grids (n, H, W) and the
// Neumann face vectors described at Faces.
template <class Equation, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(1024)
    fused_system_rk4_kernel(const float* __restrict__ y0,
                            float* __restrict__ out, Params p,
                            const uint8_t* __restrict__ dir_mask_in,
                            const float* __restrict__ dir_vals_in,
                            const uint8_t* __restrict__ grm_in,
                            const float* __restrict__ grv_in,
                            const uint8_t* __restrict__ gcm_in,
                            const float* __restrict__ gcv_in) {
  constexpr int N = Equation::kComponents;
  extern __shared__ __align__(16) float shared[];
  const int h = p.height;
  const int w = p.width;
  const int cells = h * w;
  const int values = N * cells;
  // layout (must match fused_system_shared_bytes): five sets of n float
  // planes, the float face vectors, then the byte masks
  float* state = shared;
  float* stage_a = state + values;
  float* stage_b = stage_a + values;
  float* acc = stage_b + values;
  float* dir_vals = acc + values;
  float* grv = dir_vals + values;
  float* gcv = grv + 2 * N * w;
  uint8_t* dir_mask = reinterpret_cast<uint8_t*>(gcv + 2 * N * h);
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
  __syncthreads();

  const Faces faces = {grm, grv, gcm, gcv, N};
  float k[N];
  for (int step = 0; step < p.n_steps; ++step) {
    // k1 from the state; stage_a = D(state + (d_t/2) k1)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      Equation::rhs(state, cells, i, j, c, p, faces, k);
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        const int e = comp * cells + c;
        acc[e] = k[comp];
        stage_a[e] =
            dir_mask[e] ? dir_vals[e] : state[e] + p.half_d_t * k[comp];
      }
    }
    __syncthreads();
    // k2 from stage_a; stage_b = D(state + (d_t/2) k2)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      Equation::rhs(stage_a, cells, i, j, c, p, faces, k);
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        const int e = comp * cells + c;
        acc[e] = acc[e] + 2.0f * k[comp];
        stage_b[e] =
            dir_mask[e] ? dir_vals[e] : state[e] + p.half_d_t * k[comp];
      }
    }
    __syncthreads();
    // k3 from stage_b; stage_a = D(state + d_t k3)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      Equation::rhs(stage_b, cells, i, j, c, p, faces, k);
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        const int e = comp * cells + c;
        acc[e] = acc[e] + 2.0f * k[comp];
        stage_a[e] = dir_mask[e] ? dir_vals[e] : state[e] + p.d_t * k[comp];
      }
    }
    __syncthreads();
    // k4 from stage_a; state = D(state + (d_t/6) (acc + k4)). Each thread
    // rewrites only its own cell of `state`, which no other thread reads
    // in this stage.
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      Equation::rhs(stage_a, cells, i, j, c, p, faces, k);
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        const int e = comp * cells + c;
        const float next =
            dir_mask[e] ? dir_vals[e]
                        : state[e] + p.sixth_d_t * (acc[e] + k[comp]);
        state[e] = next;
        if (WRITE_TRAJECTORY) {
          out[(b * p.n_steps + step) * values + c * N + comp] = next;
        }
      }
    }
    __syncthreads();
  }
  if (!WRITE_TRAJECTORY) {
    float* y_out = out + b * values;
    for (int e = tid; e < values; e += stride) {
      const int cell = e / N;
      y_out[e] = state[(e - cell * N) * cells + cell];
    }
  }
}

template <class Equation>
void* select_kernel(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<void*>(
                   fused_system_rk4_kernel<Equation, true>)
             : reinterpret_cast<void*>(
                   fused_system_rk4_kernel<Equation, false>);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for an H x W grid of
// n-component states.
size_t fused_system_shared_bytes(int height, int width, int n_components) {
  const size_t values = static_cast<size_t>(height) * width * n_components;
  const size_t faces = 2 * static_cast<size_t>(n_components) *
                       (static_cast<size_t>(height) + width);
  return sizeof(float) * (5 * values + faces) + values + faces;
}

const char* fused_system_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// Launches one CTA per state of y0 ((batch, H, W, n) float32, contiguous)
// on `stream` for the equation `equation` (0: Burgers in 2D, n = 2).
// Returns the cudaError_t of the launch (0 on success); the caller raises
// on anything else.
int fused_system_rk4(int equation, const float* y0, float* out, int batch,
                     int height, int width, int n_steps, int write_trajectory,
                     const uint8_t* dir_mask, const float* dir_vals,
                     const uint8_t* ghost_row_mask,
                     const float* ghost_row_vals,
                     const uint8_t* ghost_col_mask,
                     const float* ghost_col_vals, float half_d_t, float d_t,
                     float sixth_d_t, float coefficient, float inv_dx0_sqr,
                     float inv_dx1_sqr, float inv_two_dx0, float inv_two_dx1,
                     float two_dx0, float two_dx1, void* stream) {
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = nullptr;
  int n_components = 0;
  switch (equation) {
    case kBurgers2D:
      kernel = select_kernel<Burgers2D>(write_trajectory);
      n_components = Burgers2D::kComponents;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.height = height;
  p.width = width;
  p.n_steps = n_steps;
  p.half_d_t = half_d_t;
  p.d_t = d_t;
  p.sixth_d_t = sixth_d_t;
  p.coefficient = coefficient;
  p.inv_dx0_sqr = inv_dx0_sqr;
  p.inv_dx1_sqr = inv_dx1_sqr;
  p.inv_two_dx0 = inv_two_dx0;
  p.inv_two_dx1 = inv_two_dx1;
  p.two_dx0 = two_dx0;
  p.two_dx1 = two_dx1;

  const size_t shared_bytes =
      fused_system_shared_bytes(height, width, n_components);
  const int cells = height * width;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;

  if (shared_bytes > 48 * 1024) {
    cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  void* args[] = {&y0,       &out,           &p,
                  &dir_mask, &dir_vals,      &ghost_row_mask,
                  &ghost_row_vals, &ghost_col_mask, &ghost_col_vals};
  cudaError_t error =
      cudaLaunchKernel(kernel, dim3(batch), dim3(threads), args,
                       shared_bytes, static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
