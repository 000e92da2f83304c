// Fused RK4 kernels for single-component 2D Cartesian diffusion and
// convection-diffusion with static boundary conditions, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in ops/fused_diffusion.py:
//   K1 build_fused_diffusion_rk4_trajectory (every step stored),
//   K2 build_fused_diffusion_rk4_end (end state only; single or batched),
//   K3 build_fused_diffusion_rk4_step (one step: K1 with n_steps = 1).
// All three are instances of one kernel template, computing what
// _KernelConfig.make_rk4 computes, term for term and in the same order:
// classic k1..k4 with the Dirichlet grid applied after each stage and at
// the end, the Neumann ghost row and column corrections added after the
// interior 5-point Laplacian (rows first, then columns), and the
// constrained-derivative overrides of the central first derivatives for
// convection.
//
// What bounds it on the card: not bytes or FLOPs. The main path's grid
// is 21 x 21 (441 cells, 1.7 KB of state) and one RK4 step is ~30 FLOPs a
// cell; the 40,000-step solve is a chain of 160,000 dependent stages, so
// the limit is the latency of one stage (a few shared-memory loads, some
// arithmetic and a block-wide barrier).
//
// What the design does about it: one CTA owns one state for all n_steps,
// so the chain never leaves the SM. The state, the two stage buffers,
// the RK4 accumulator and the constraint tensors live in shared memory
// for the whole solve, a __syncthreads() separates the four stages, and
// the only device-memory traffic is the initial read plus either one
// coalesced row-major store per step (trajectory) or the final store
// (end). A batch of states (Parareal's slices) is the grid: one CTA per
// state, so B slices fill B SMs. The TPU kernel's (8, 128) padding, DMA
// double-buffering and VMEM gates are not carried over: the layout is
// the unpadded H x W grid. The grid fits when fused_diffusion_shared_bytes
// is at most the 227 KB a block can opt into.
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
  float d;
  float d_t;
  float inv_dx0_sqr;
  float inv_dx1_sqr;
  float inv_two_dx0;
  float inv_two_dx1;
  float two_dx0;
  float two_dx1;
  float velocity0;
  float velocity1;
};

// d * Laplacian (minus the convection term) at cell (i, j) of `s`,
// with zero halos, Neumann ghost corrections from the ghost row
// (grm/grv: 2 x W, lower then upper face of axis 0) and ghost column
// (gcm/gcv: 2 x H, lower then upper face of axis 1) tensors.
template <bool HAS_CONVECTION>
__device__ __forceinline__ float rhs(const float* s, int i, int j, int idx,
                                     const Params& p, const uint8_t* grm,
                                     const float* grv, const uint8_t* gcm,
                                     const float* gcv) {
  const int h = p.height;
  const int w = p.width;
  const float c = s[idx];
  const float above = i > 0 ? s[idx - w] : 0.0f;
  const float below = i < h - 1 ? s[idx + w] : 0.0f;
  const float left = j > 0 ? s[idx - 1] : 0.0f;
  const float right = j < w - 1 ? s[idx + 1] : 0.0f;
  float lap = (above - 2.0f * c + below) * p.inv_dx0_sqr +
              (left - 2.0f * c + right) * p.inv_dx1_sqr;
  if (i == 0 && grm[j]) {
    lap = lap + (below - p.two_dx0 * grv[j]) * p.inv_dx0_sqr;
  }
  if (i == h - 1 && grm[w + j]) {
    lap = lap + (above + p.two_dx0 * grv[w + j]) * p.inv_dx0_sqr;
  }
  if (j == 0 && gcm[i]) {
    lap = lap + (right - p.two_dx1 * gcv[i]) * p.inv_dx1_sqr;
  }
  if (j == w - 1 && gcm[h + i]) {
    lap = lap + (left + p.two_dx1 * gcv[h + i]) * p.inv_dx1_sqr;
  }
  float value = p.d * lap;
  if (HAS_CONVECTION) {
    float gradient0 = (below - above) * p.inv_two_dx0;
    if (i == 0 && grm[j]) gradient0 = grv[j];
    if (i == h - 1 && grm[w + j]) gradient0 = grv[w + j];
    float gradient1 = (right - left) * p.inv_two_dx1;
    if (j == 0 && gcm[i]) gradient1 = gcv[i];
    if (j == w - 1 && gcm[h + i]) gradient1 = gcv[h + i];
    value = value - p.velocity0 * gradient0 - p.velocity1 * gradient1;
  }
  return value;
}

__device__ __forceinline__ float dirichlet(const uint8_t* mask,
                                           const float* values, int idx,
                                           float x) {
  return mask[idx] ? values[idx] : x;
}

// One CTA advances state blockIdx.x of `y0` ((B, H, W), row-major) by
// n_steps RK4 steps. WRITE_TRAJECTORY: out is (B, n_steps, H, W) and
// receives every step; otherwise out is (B, H, W) and receives the end.
template <bool WRITE_TRAJECTORY, bool HAS_CONVECTION>
__global__ void __launch_bounds__(1024)
    fused_diffusion_rk4_kernel(const float* __restrict__ y0,
                               float* __restrict__ out, Params p,
                               const uint8_t* __restrict__ dir_mask_in,
                               const float* __restrict__ dir_vals_in,
                               const uint8_t* __restrict__ grm_in,
                               const float* __restrict__ grv_in,
                               const uint8_t* __restrict__ gcm_in,
                               const float* __restrict__ gcv_in) {
  extern __shared__ __align__(16) float shared[];
  const int h = p.height;
  const int w = p.width;
  const int cells = h * w;
  // layout (must match fused_diffusion_shared_bytes): five float grids,
  // the float ghost vectors, then the byte masks
  float* state = shared;
  float* stage_a = state + cells;
  float* stage_b = stage_a + cells;
  float* acc = stage_b + cells;
  float* dir_vals = acc + cells;
  float* grv = dir_vals + cells;
  float* gcv = grv + 2 * w;
  uint8_t* dir_mask = reinterpret_cast<uint8_t*>(gcv + 2 * h);
  uint8_t* grm = dir_mask + cells;
  uint8_t* gcm = grm + 2 * w;

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  const float* y_in = y0 + b * cells;
  for (int c = tid; c < cells; c += stride) {
    state[c] = y_in[c];
    dir_vals[c] = dir_vals_in[c];
    dir_mask[c] = dir_mask_in[c];
  }
  for (int c = tid; c < 2 * w; c += stride) {
    grv[c] = grv_in[c];
    grm[c] = grm_in[c];
  }
  for (int c = tid; c < 2 * h; c += stride) {
    gcv[c] = gcv_in[c];
    gcm[c] = gcm_in[c];
  }
  __syncthreads();

  for (int k = 0; k < p.n_steps; ++k) {
    // k1 from the state; stage_a = D(state + k1 / 2)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      const float k1 = p.d_t * rhs<HAS_CONVECTION>(state, i, j, c, p, grm,
                                                   grv, gcm, gcv);
      acc[c] = k1;
      stage_a[c] = dirichlet(dir_mask, dir_vals, c, state[c] + 0.5f * k1);
    }
    __syncthreads();
    // k2 from stage_a; stage_b = D(state + k2 / 2)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      const float k2 = p.d_t * rhs<HAS_CONVECTION>(stage_a, i, j, c, p, grm,
                                                   grv, gcm, gcv);
      acc[c] = acc[c] + 2.0f * k2;
      stage_b[c] = dirichlet(dir_mask, dir_vals, c, state[c] + 0.5f * k2);
    }
    __syncthreads();
    // k3 from stage_b; stage_a = D(state + k3)
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      const float k3 = p.d_t * rhs<HAS_CONVECTION>(stage_b, i, j, c, p, grm,
                                                   grv, gcm, gcv);
      acc[c] = acc[c] + 2.0f * k3;
      stage_a[c] = dirichlet(dir_mask, dir_vals, c, state[c] + k3);
    }
    __syncthreads();
    // k4 from stage_a; state = D(state + (k1 + 2 k2 + 2 k3 + k4) / 6).
    // Each thread rewrites only its own cells of `state`, which no other
    // thread reads in this stage.
    for (int c = tid; c < cells; c += stride) {
      const int i = c / w;
      const int j = c - i * w;
      const float k4 = p.d_t * rhs<HAS_CONVECTION>(stage_a, i, j, c, p, grm,
                                                   grv, gcm, gcv);
      const float next =
          dirichlet(dir_mask, dir_vals, c, state[c] + (acc[c] + k4) / 6.0f);
      state[c] = next;
      if (WRITE_TRAJECTORY) {
        out[(b * p.n_steps + k) * cells + c] = next;
      }
    }
    __syncthreads();
  }
  if (!WRITE_TRAJECTORY) {
    for (int c = tid; c < cells; c += stride) {
      out[b * cells + c] = state[c];
    }
  }
}

template <bool WRITE_TRAJECTORY>
void* select_kernel(int has_convection) {
  return has_convection
             ? reinterpret_cast<void*>(
                   fused_diffusion_rk4_kernel<WRITE_TRAJECTORY, true>)
             : reinterpret_cast<void*>(
                   fused_diffusion_rk4_kernel<WRITE_TRAJECTORY, false>);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for an H x W grid.
size_t fused_diffusion_shared_bytes(int height, int width) {
  const size_t cells = static_cast<size_t>(height) * width;
  const size_t faces = 2 * static_cast<size_t>(height + width);
  return sizeof(float) * (5 * cells + faces) + cells + faces;
}

const char* fused_diffusion_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// Launches one CTA per state of y0 ((batch, H, W) float32, contiguous) on
// `stream`. Returns the cudaError_t of the launch (0 on success); the
// caller raises on anything else.
int fused_diffusion_rk4(const float* y0, float* out, int batch, int height,
                        int width, int n_steps, int write_trajectory,
                        int has_convection, const uint8_t* dir_mask,
                        const float* dir_vals, const uint8_t* ghost_row_mask,
                        const float* ghost_row_vals,
                        const uint8_t* ghost_col_mask,
                        const float* ghost_col_vals, float d, float d_t,
                        float inv_dx0_sqr, float inv_dx1_sqr,
                        float inv_two_dx0, float inv_two_dx1, float two_dx0,
                        float two_dx1, float velocity0, float velocity1,
                        void* stream) {
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.height = height;
  p.width = width;
  p.n_steps = n_steps;
  p.d = d;
  p.d_t = d_t;
  p.inv_dx0_sqr = inv_dx0_sqr;
  p.inv_dx1_sqr = inv_dx1_sqr;
  p.inv_two_dx0 = inv_two_dx0;
  p.inv_two_dx1 = inv_two_dx1;
  p.two_dx0 = two_dx0;
  p.two_dx1 = two_dx1;
  p.velocity0 = velocity0;
  p.velocity1 = velocity1;

  const size_t shared_bytes = fused_diffusion_shared_bytes(height, width);
  const int cells = height * width;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;

  void* kernel = write_trajectory ? select_kernel<true>(has_convection)
                                  : select_kernel<false>(has_convection);
  if (shared_bytes > 48 * 1024) {
    cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  void* args[] = {&y0,       &out,            &p,
                  &dir_mask, &dir_vals,       &ghost_row_mask,
                  &ghost_row_vals, &ghost_col_mask, &ghost_col_vals};
  cudaError_t error = cudaLaunchKernel(
      kernel, dim3(batch), dim3(threads), args, shared_bytes,
      static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
