// Fused RK4 kernels for 3D Cartesian problems with static boundary
// conditions, for Hopper (sm_90a): diffusion, convection-diffusion, wave,
// Burgers and Cahn-Hilliard.
//
// Replaces the JAX package's Pallas TPU kernels of ops/fused_system_3d.py
// (K9): build_fused_system_3d_rk4_trajectory (every step stored),
// build_fused_system_3d_rk4_end (end state, single or batched) and
// build_fused_system_3d_rk4_step (one step: the trajectory with n_steps =
// 1). All of them are launches of one kernel template, templated on an
// equation functor and on whether every step is stored. It computes what
// the JAX package's step factories compute over its _StencilHelpers3D,
// term for term and in the same order. For the four RK4 families
//   k1 = f(y), k2 = f(D(y + (d_t/2) k1)), k3 = f(D(y + (d_t/2) k2)),
//   k4 = f(D(y + d_t k3)), y' = D(y + (d_t/6) (((k1 + 2 k2) + 2 k3) + k4)),
// with D the per-component Dirichlet override, and for Cahn-Hilliard its
// own step (y1, the chemical potential, held through the stages):
//   k1 = d lap(y1), k_rest = d lap(D1(y1)),
//   y0' = D0(y0 + (d_t/6) (k1 + 5 k_rest)),
//   y1' = D1(((y0 y0) y0 - y0) - gamma lap(y0)).
// The Laplacian sums the three axis terms (lo - 2 s + hi) / dx^2 in axis
// order, then adds each axis's masked Neumann ghost correction
// m (inner -/+ 2 dx g) / dx^2 on that axis's two faces, axis by axis; a
// gradient is a central difference whose face values are the masked blend
// m g + (1 - m) grad. Out-of-grid neighbours read as zero.
//
// What bounds it on the card: neither bytes nor FLOPs. The main path's
// volumes are 21^3 x 3 (27,783 values) and 31^3 x 2 (59,582 values), and a
// step is four (Cahn-Hilliard: two) dependent stages over them, each a few
// shared-memory loads and some tens of operations a cell, separated by a
// barrier. The bound of 2,000 Burgers steps at 21^3 is about 0.09 ms.
//
// What the design does about it: the state stays on-chip for all n_steps,
// as on the TPU, where one core's VMEM held the whole volume. On Hopper the
// working set (5n floats and n bytes a cell: about 583 KB at 21^3 x 3,
// 1.25 MB at 31^3 x 2) does not fit one block's 227 KB, so one thread
// block cluster holds one state. Its blocks split the depth axis (axis 0)
// into slabs of consecutive planes; each keeps its slab's state, two stage
// buffers (ping-pong), the RK4 accumulator, the Dirichlet values and the
// Dirichlet byte masks in its own shared memory for the whole solve. A
// neighbour across a slab edge is read from the neighbouring block's
// shared memory through distributed shared memory
// (cooperative_groups::this_cluster().map_shared_rank), and
// cluster.sync() separates the stages. One barrier per stage is enough:
// a stage reads one buffer and writes another (state -> stage_a -> stage_b
// -> stage_a -> state), so no block overwrites what a neighbour may still
// read before the next barrier. The Neumann face data are read from device
// memory through the read-only cache: only face cells touch them. A batch
// of states is the grid: one cluster per state (Parareal's fine ends, a
// trajectory's leading axis). The trajectory is stored in the JAX
// package's (..., steps, D, H, W, n) layout, each thread writing its
// cell's n values. The TPU kernels' (8, 128) padding and DMA
// double-buffering are not carried over. The host picks the cluster size
// (1, 2, 4 or 8 blocks: the smallest whose largest slab fits 227 KB) and
// refuses, without launching, a cluster the card cannot place
// (cudaOccupancyMaxActiveClusters). Making it fast (register tiling of
// the stage loop, TMA slab loads, multicast) is later work.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;

struct Params {
  int depth;
  int height;
  int width;
  int n_steps;
  int cluster_size;
  // the largest number of planes one block holds
  int slab;
  // bit a set where velocity component a is nonzero (convection-diffusion)
  int velocity_mask;
  float half_d_t;
  float d_t;
  float sixth_d_t;
  // the equation's coefficient: d (diffusion, convection-diffusion,
  // Cahn-Hilliard), c^2 (wave) or 1 / Re (Burgers)
  float coefficient;
  float gamma;
  float inv_dx_sqr[3];
  float inv_two_dx[3];
  float two_dx[3];
  float velocity[3];
};

// The Neumann face data in device memory, per axis: masks and values of
// shape (2 faces, n components, the other two axes), lower face first (the
// layout of the JAX package's _component_constraint_tensors_3d).
struct Faces {
  const uint8_t* mask[3];
  const float* vals[3];
};

struct Args {
  const float* y0;
  float* out;
  const uint8_t* dir_mask;
  const float* dir_vals;
  Faces faces;
  Params p;
};

// This block's part of the volume: planes [z_begin, z_begin + planes) of
// axis 0, kept in shared memory as n component slabs of `stride` values.
struct Slab {
  int z_begin;
  int planes;
  int hw;
  int stride;
  int cells;
};

// A stage input as this block sees it: its own slab and, through
// distributed shared memory, the neighbouring blocks' edge planes.
struct Volume {
  const float* local;
  // the previous block's last plane and the next block's first plane, of
  // component 0 (components follow at `stride`), or nullptr at the faces
  const float* prev;
  const float* next;
};

// A barrier over every thread of every block of the cluster, which also
// makes each block's shared-memory writes before it visible to the others.
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

struct Cell {
  int lc;  // index in the slab
  int lz;  // plane in the slab
  int ij;  // index in the plane
  int pos[3];  // z, i, j in the volume
};

// One component's value at a cell and its six neighbours, zero outside.
struct Neighbours {
  float c;
  float lo[3];
  float hi[3];
};

__device__ __forceinline__ Neighbours fetch(const Volume& v, int comp,
                                            const Cell& x, const Slab& s,
                                            const Params& p) {
  const int offset = comp * s.stride;
  const float* slab = v.local + offset;
  Neighbours n;
  n.c = slab[x.lc];
  n.lo[0] = x.lz > 0 ? slab[x.lc - s.hw]
                     : (v.prev != nullptr ? v.prev[offset + x.ij] : 0.0f);
  n.hi[0] = x.lz < s.planes - 1
                ? slab[x.lc + s.hw]
                : (v.next != nullptr ? v.next[offset + x.ij] : 0.0f);
  n.lo[1] = x.pos[1] > 0 ? slab[x.lc - p.width] : 0.0f;
  n.hi[1] = x.pos[1] < p.height - 1 ? slab[x.lc + p.width] : 0.0f;
  n.lo[2] = x.pos[2] > 0 ? slab[x.lc - 1] : 0.0f;
  n.hi[2] = x.pos[2] < p.width - 1 ? slab[x.lc + 1] : 0.0f;
  return n;
}

__device__ __forceinline__ int axis_size(int axis, const Params& p) {
  return axis == 0 ? p.depth : (axis == 1 ? p.height : p.width);
}

// The cell's entry in face `side` of `axis`, component `comp`.
__device__ __forceinline__ int face_index(int axis, int side, int comp,
                                          int n_components, const Cell& x,
                                          const Params& p) {
  const int face = side * n_components + comp;
  if (axis == 0) return (face * p.height + x.pos[1]) * p.width + x.pos[2];
  if (axis == 1) return (face * p.depth + x.pos[0]) * p.width + x.pos[2];
  return (face * p.depth + x.pos[0]) * p.height + x.pos[1];
}

// _StencilHelpers3D.laplacian of component `comp`.
__device__ __forceinline__ float laplacian(const Neighbours& n, int comp,
                                           int n_components, const Cell& x,
                                           const Params& p, const Faces& f) {
  float lap = (n.lo[0] - 2.0f * n.c + n.hi[0]) * p.inv_dx_sqr[0];
  lap = lap + (n.lo[1] - 2.0f * n.c + n.hi[1]) * p.inv_dx_sqr[1];
  lap = lap + (n.lo[2] - 2.0f * n.c + n.hi[2]) * p.inv_dx_sqr[2];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const int pos = x.pos[axis];
    if (pos == 0) {
      // ghost = inner neighbour - 2 dx g
      const int k = face_index(axis, 0, comp, n_components, x, p);
      const float m = __ldg(f.mask[axis] + k) ? 1.0f : 0.0f;
      const float ghost =
          m * (n.hi[axis] - p.two_dx[axis] * __ldg(f.vals[axis] + k));
      lap = lap + ghost * p.inv_dx_sqr[axis];
    } else if (pos == axis_size(axis, p) - 1) {
      // ghost = inner neighbour + 2 dx g
      const int k = face_index(axis, 1, comp, n_components, x, p);
      const float m = __ldg(f.mask[axis] + k) ? 1.0f : 0.0f;
      const float ghost =
          m * (n.lo[axis] + p.two_dx[axis] * __ldg(f.vals[axis] + k));
      lap = lap + ghost * p.inv_dx_sqr[axis];
    }
  }
  return lap;
}

// _StencilHelpers3D.gradient along `axis` of component `comp`.
__device__ __forceinline__ float gradient(int axis, const Neighbours& n,
                                          int comp, int n_components,
                                          const Cell& x, const Params& p,
                                          const Faces& f) {
  float g = (n.hi[axis] - n.lo[axis]) * p.inv_two_dx[axis];
  const int pos = x.pos[axis];
  int side = -1;
  if (pos == 0) {
    side = 0;
  } else if (pos == axis_size(axis, p) - 1) {
    side = 1;
  }
  if (side >= 0) {
    const int k = face_index(axis, side, comp, n_components, x, p);
    const float m = __ldg(f.mask[axis] + k) ? 1.0f : 0.0f;
    g = m * __ldg(f.vals[axis] + k) + (1.0f - m) * g;
  }
  return g;
}

// The right-hand sides of the JAX package's _make_rhs_builder_3d, one
// functor per family: rhs() writes every component's value at one cell.
struct Diffusion3D {
  static constexpr int kComponents = 1;
  static constexpr bool kRK4 = true;
  static __device__ __forceinline__ void rhs(const Volume& v, const Cell& x,
                                             const Slab& s, const Params& p,
                                             const Faces& f, float* out) {
    const Neighbours n = fetch(v, 0, x, s, p);
    out[0] = p.coefficient * laplacian(n, 0, kComponents, x, p, f);
  }
};

struct ConvectionDiffusion3D {
  static constexpr int kComponents = 1;
  static constexpr bool kRK4 = true;
  static __device__ __forceinline__ void rhs(const Volume& v, const Cell& x,
                                             const Slab& s, const Params& p,
                                             const Faces& f, float* out) {
    const Neighbours n = fetch(v, 0, x, s, p);
    float result = p.coefficient * laplacian(n, 0, kComponents, x, p, f);
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      if (p.velocity_mask & (1 << axis)) {
        result = result - p.velocity[axis] *
                              gradient(axis, n, 0, kComponents, x, p, f);
      }
    }
    out[0] = result;
  }
};

struct Wave3D {
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = true;
  static __device__ __forceinline__ void rhs(const Volume& v, const Cell& x,
                                             const Slab& s, const Params& p,
                                             const Faces& f, float* out) {
    const Neighbours n = fetch(v, 0, x, s, p);
    out[0] = v.local[s.stride + x.lc];
    out[1] = p.coefficient * laplacian(n, 0, kComponents, x, p, f);
  }
};

struct Burgers3D {
  static constexpr int kComponents = 3;
  static constexpr bool kRK4 = true;
  static __device__ __forceinline__ void rhs(const Volume& v, const Cell& x,
                                             const Slab& s, const Params& p,
                                             const Faces& f, float* out) {
    const float y_0 = v.local[x.lc];
    const float y_1 = v.local[s.stride + x.lc];
    const float y_2 = v.local[2 * s.stride + x.lc];
#pragma unroll
    for (int comp = 0; comp < kComponents; ++comp) {
      const Neighbours n = fetch(v, comp, x, s, p);
      out[comp] =
          p.coefficient * laplacian(n, comp, kComponents, x, p, f) -
          y_0 * gradient(0, n, comp, kComponents, x, p, f) -
          y_1 * gradient(1, n, comp, kComponents, x, p, f) -
          y_2 * gradient(2, n, comp, kComponents, x, p, f);
    }
  }
};

// Cahn-Hilliard has its own step (see the header); no rhs().
struct CahnHilliard3D {
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = false;
};

enum EquationId {
  kDiffusion3D = 0,
  kConvectionDiffusion3D = 1,
  kWave3D = 2,
  kBurgers3D = 3,
  kCahnHilliard3D = 4,
};

// The shared-memory buffers of one block, each n component slabs of
// `stride` values (the byte masks likewise).
struct Buffers {
  float* state;
  float* stage_a;
  float* stage_b;
  float* acc;
  float* dir_vals;
  uint8_t* dir_mask;
};

__device__ __forceinline__ Cell make_cell(int lc, const Slab& s,
                                          const Params& p) {
  Cell x;
  x.lc = lc;
  x.lz = lc / s.hw;
  x.ij = lc - x.lz * s.hw;
  x.pos[0] = s.z_begin + x.lz;
  x.pos[1] = x.ij / p.width;
  x.pos[2] = x.ij - x.pos[1] * p.width;
  return x;
}

// Stage STAGE (0-3) of an RK4 step over the slab, reading `in` and
// writing the accumulator and `next` (STAGE < 3) or the state and the
// step's frame (STAGE == 3; `frame` is this block's part of it).
template <class Equation, int STAGE, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void rk4_stage(const Volume& in, float* next,
                                          const Buffers& bf, const Slab& s,
                                          const Params& p, const Faces& f,
                                          float* frame) {
  constexpr int N = Equation::kComponents;
  float k[N];
  for (int lc = threadIdx.x; lc < s.cells; lc += blockDim.x) {
    const Cell x = make_cell(lc, s, p);
    Equation::rhs(in, x, s, p, f, k);
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      const int e = comp * s.stride + lc;
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
        // block reads in this stage
        const float value =
            fixed ? bf.dir_vals[e]
                  : bf.state[e] + p.sixth_d_t * (bf.acc[e] + k[comp]);
        bf.state[e] = value;
        if constexpr (WRITE_TRAJECTORY) {
          frame[static_cast<size_t>(lc) * N + comp] = value;
        }
      }
    }
  }
}

// One Cahn-Hilliard step: stage A reads the state, stage B reads D1(y1)
// from stage_a; a cluster barrier follows each.
template <bool WRITE_TRAJECTORY>
__device__ __forceinline__ void cahn_hilliard_step(
    const Volume& state_in, const Volume& stage_in, const Buffers& bf,
    const Slab& s, const Params& p, const Faces& f, float* frame) {
  constexpr int N = CahnHilliard3D::kComponents;
  for (int lc = threadIdx.x; lc < s.cells; lc += blockDim.x) {
    const Cell x = make_cell(lc, s, p);
    const int e0 = lc;
    const int e1 = s.stride + lc;
    const Neighbours n1 = fetch(state_in, 1, x, s, p);
    const float k1 = p.coefficient * laplacian(n1, 1, N, x, p, f);
    const Neighbours n0 = fetch(state_in, 0, x, s, p);
    const float y0 = n0.c;
    const float potential =
        ((y0 * y0) * y0 - y0) - p.gamma * laplacian(n0, 0, N, x, p, f);
    const bool fixed1 = bf.dir_mask[e1] != 0;
    bf.acc[e0] = k1;
    bf.acc[e1] = fixed1 ? bf.dir_vals[e1] : potential;
    bf.stage_a[e1] = fixed1 ? bf.dir_vals[e1] : n1.c;
  }
  cluster_barrier();
  for (int lc = threadIdx.x; lc < s.cells; lc += blockDim.x) {
    const Cell x = make_cell(lc, s, p);
    const int e0 = lc;
    const int e1 = s.stride + lc;
    const Neighbours n = fetch(stage_in, 1, x, s, p);
    const float k_rest = p.coefficient * laplacian(n, 1, N, x, p, f);
    const float combined = bf.acc[e0] + 5.0f * k_rest;
    const float y0 = bf.dir_mask[e0] ? bf.dir_vals[e0]
                                     : bf.state[e0] + p.sixth_d_t * combined;
    const float y1 = bf.acc[e1];
    bf.state[e0] = y0;
    bf.state[e1] = y1;
    if constexpr (WRITE_TRAJECTORY) {
      frame[static_cast<size_t>(lc) * N] = y0;
      frame[static_cast<size_t>(lc) * N + 1] = y1;
    }
  }
  cluster_barrier();
}

// One cluster of p.cluster_size blocks advances state blockIdx.x /
// cluster_size of `y0` ((B, D, H, W, n), row-major) by n_steps steps.
// WRITE_TRAJECTORY: out is (B, n_steps, D, H, W, n) and receives every
// step; otherwise out is (B, D, H, W, n) and receives the end. dir_mask
// and dir_vals are the Dirichlet volumes (n, D, H, W).
template <class Equation, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(kMaxThreads)
    fused_system_3d_rk4_kernel(const Args a) {
  constexpr int N = Equation::kComponents;
  cg::cluster_group cluster = cg::this_cluster();
  const Params& p = a.p;
  const int cluster_size = p.cluster_size;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / cluster_size;

  Slab s;
  s.z_begin = rank * p.depth / cluster_size;
  s.planes = (rank + 1) * p.depth / cluster_size - s.z_begin;
  s.hw = p.height * p.width;
  s.stride = p.slab * s.hw;
  s.cells = s.planes * s.hw;
  const size_t volume = static_cast<size_t>(p.depth) * s.hw;
  const size_t slab_offset = static_cast<size_t>(s.z_begin) * s.hw;

  // layout (sized by shared_memory_bytes_3d in ops/fused_system_3d.py):
  // five sets of n float slabs, then the n byte-mask slabs
  extern __shared__ __align__(16) float shared[];
  const int values = N * s.stride;
  Buffers bf;
  bf.state = shared;
  bf.stage_a = bf.state + values;
  bf.stage_b = bf.stage_a + values;
  bf.acc = bf.stage_b + values;
  bf.dir_vals = bf.acc + values;
  bf.dir_mask = reinterpret_cast<uint8_t*>(bf.dir_vals + values);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  // the state arrives interleaved ((D, H, W, n)) and is kept as slabs
  const float* y_in = a.y0 + (b * volume + slab_offset) * N;
  for (int e = tid; e < N * s.cells; e += threads) {
    const int cell = e / N;
    bf.state[(e - cell * N) * s.stride + cell] = y_in[e];
  }
  for (int comp = 0; comp < N; ++comp) {
    const size_t base = comp * volume + slab_offset;
    for (int lc = tid; lc < s.cells; lc += threads) {
      bf.dir_vals[comp * s.stride + lc] = a.dir_vals[base + lc];
      bf.dir_mask[comp * s.stride + lc] = a.dir_mask[base + lc];
    }
  }
  // every block of the cluster has started and loaded its slab before any
  // reads a neighbour's shared memory
  cluster_barrier();

  const int prev_planes =
      rank > 0 ? s.z_begin - (rank - 1) * p.depth / cluster_size : 0;
  auto view = [&](float* buffer) {
    Volume v;
    v.local = buffer;
    v.prev = rank > 0 ? cluster.map_shared_rank(buffer, rank - 1) +
                            (prev_planes - 1) * s.hw
                      : nullptr;
    v.next = rank < cluster_size - 1
                 ? cluster.map_shared_rank(buffer, rank + 1)
                 : nullptr;
    return v;
  };
  const Volume state_in = view(bf.state);
  const Volume stage_a_in = view(bf.stage_a);
  const Volume stage_b_in = view(bf.stage_b);

  for (int step = 0; step < p.n_steps; ++step) {
    float* frame =
        WRITE_TRAJECTORY
            ? a.out + ((b * p.n_steps + step) * volume + slab_offset) * N
            : nullptr;
    if constexpr (Equation::kRK4) {
      rk4_stage<Equation, 0, WRITE_TRAJECTORY>(state_in, bf.stage_a, bf, s,
                                               p, a.faces, frame);
      cluster_barrier();
      rk4_stage<Equation, 1, WRITE_TRAJECTORY>(stage_a_in, bf.stage_b, bf, s,
                                               p, a.faces, frame);
      cluster_barrier();
      rk4_stage<Equation, 2, WRITE_TRAJECTORY>(stage_b_in, bf.stage_a, bf, s,
                                               p, a.faces, frame);
      cluster_barrier();
      rk4_stage<Equation, 3, WRITE_TRAJECTORY>(stage_a_in, nullptr, bf, s, p,
                                               a.faces, frame);
      cluster_barrier();
    } else {
      cahn_hilliard_step<WRITE_TRAJECTORY>(state_in, stage_a_in, bf, s, p,
                                           a.faces, frame);
    }
  }
  // the loop ends on a cluster barrier: no neighbour reads this block's
  // shared memory any more, so the block may write its end state and exit
  if (!WRITE_TRAJECTORY) {
    float* y_out = a.out + (b * volume + slab_offset) * N;
    for (int e = tid; e < N * s.cells; e += threads) {
      const int cell = e / N;
      y_out[e] = bf.state[(e - cell * N) * s.stride + cell];
    }
  }
}

template <class Equation>
const void* select_kernel(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   fused_system_3d_rk4_kernel<Equation, true>)
             : reinterpret_cast<const void*>(
                   fused_system_3d_rk4_kernel<Equation, false>);
}

}  // namespace

extern "C" {

const char* fused_system_3d_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// Launches one cluster of cluster_size blocks per state of y0 ((batch, D,
// H, W, n) float32, contiguous) on `stream` for the equation `equation`
// (see EquationId). Each block holds a slab of at most `slab` planes in
// `shared_bytes` of dynamic shared memory, as the caller's cluster plan
// sizes them (shared_memory_bytes_3d in ops/fused_system_3d.py).
// coefficients holds, in order: d_t / 2, d_t, d_t / 6, the coefficient,
// gamma, 1 / dx_a^2, 1 / (2 dx_a), 2 dx_a and the velocity v_a (a = 0, 1,
// 2). Returns cudaErrorCooperativeLaunchTooLarge,
// without launching, when the card cannot place one such cluster, else the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else than 0.
int fused_system_3d_rk4(int equation, const float* y0, float* out,
                        int batch, int depth, int height, int width,
                        int n_steps, int write_trajectory, int cluster_size,
                        int slab, size_t shared_bytes,
                        const uint8_t* dir_mask, const float* dir_vals,
                        const uint8_t* face_mask_0, const float* face_vals_0,
                        const uint8_t* face_mask_1, const float* face_vals_1,
                        const uint8_t* face_mask_2, const float* face_vals_2,
                        const float* coefficients, int velocity_mask,
                        void* stream) {
  if (batch <= 0 || n_steps <= 0 || depth < 2 || height < 2 || width < 2 ||
      !(cluster_size == 1 || cluster_size == 2 || cluster_size == 4 ||
        cluster_size == 8) ||
      depth < cluster_size ||
      slab < (depth + cluster_size - 1) / cluster_size || shared_bytes == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = nullptr;
  switch (equation) {
    case kDiffusion3D:
      kernel = select_kernel<Diffusion3D>(write_trajectory);
      break;
    case kConvectionDiffusion3D:
      kernel = select_kernel<ConvectionDiffusion3D>(write_trajectory);
      break;
    case kWave3D:
      kernel = select_kernel<Wave3D>(write_trajectory);
      break;
    case kBurgers3D:
      kernel = select_kernel<Burgers3D>(write_trajectory);
      break;
    case kCahnHilliard3D:
      kernel = select_kernel<CahnHilliard3D>(write_trajectory);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }

  Args a;
  a.y0 = y0;
  a.out = out;
  a.dir_mask = dir_mask;
  a.dir_vals = dir_vals;
  a.faces.mask[0] = face_mask_0;
  a.faces.mask[1] = face_mask_1;
  a.faces.mask[2] = face_mask_2;
  a.faces.vals[0] = face_vals_0;
  a.faces.vals[1] = face_vals_1;
  a.faces.vals[2] = face_vals_2;
  Params& p = a.p;
  p.depth = depth;
  p.height = height;
  p.width = width;
  p.n_steps = n_steps;
  p.cluster_size = cluster_size;
  p.slab = slab;
  p.velocity_mask = velocity_mask;
  p.half_d_t = coefficients[0];
  p.d_t = coefficients[1];
  p.sixth_d_t = coefficients[2];
  p.coefficient = coefficients[3];
  p.gamma = coefficients[4];
  for (int axis = 0; axis < 3; ++axis) {
    p.inv_dx_sqr[axis] = coefficients[5 + axis];
    p.inv_two_dx[axis] = coefficients[8 + axis];
    p.two_dx[axis] = coefficients[11 + axis];
    p.velocity[axis] = coefficients[14 + axis];
  }

  const int cells = p.slab * height * width;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;

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
