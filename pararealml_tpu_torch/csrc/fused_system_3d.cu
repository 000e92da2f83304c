// Fused RK4 kernels for 3D Cartesian problems with static boundary
// conditions, for Hopper (sm_90a): diffusion, convection-diffusion, wave,
// Burgers and Cahn-Hilliard.
//
// Replaces the JAX package's Pallas TPU kernels of ops/fused_system_3d.py
// (K9): build_fused_system_3d_rk4_trajectory (every step stored),
// build_fused_system_3d_rk4_end (end state, single or batched) and
// build_fused_system_3d_rk4_step (one step: the trajectory with n_steps =
// 1). All of them are launches of one kernel template, templated on an
// equation functor, on where a thread keeps its cells and on whether every
// step is stored. It computes what the JAX package's step factories
// compute over its _StencilHelpers3D, term for term and in the same order.
// For the four RK4 families
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
// What held the first design back (tools/k9_step_split.py, NVIDIA H100
// 80GB HBM3 at 700 W, 41.9 us a 21^3 Burgers step on 4 blocks): per cell
// and stage two divisions, six face tests with their face_index and
// read-only-cache loads, and the update's shared-memory reads of state,
// accumulator and Dirichlet data cost 2-4x the stage's arithmetic, and
// the barriers waited for the largest of four slabs of 5-6 planes.
//
// The design. One thread block cluster of up to 16 blocks (past 8 a
// non-portable size) holds one state for all n_steps, as one TPU core's
// VMEM did; its blocks split the depth axis (axis 0) into slabs of
// consecutive planes (block r: planes [r D / s, (r + 1) D / s)). Shared
// memory holds only what neighbours read: the stage input, ping-ponged
// between two sets of n component slabs (8n bytes a cell), so that a stage
// reads one set and writes the other and one cluster barrier a stage is
// enough. Across a slab edge the RK4 families push each stage's edge
// planes into the neighbouring blocks' halo planes through distributed
// shared memory (cooperative_groups::this_cluster().map_shared_rank);
// Cahn-Hilliard, and every family where the cells live in device memory,
// read the neighbours' edge planes instead (see HaloVolume). Each thread
// owns fixed cells of its block's slab, worked out once before the first
// step (interior cells first, then the cells on the grid's faces, so that
// whole warps take the path without face tests): its index in the slab,
// its face and slab-edge flags, its Dirichlet mask and values and, for a
// face cell, its Neumann masks and values, beside the cell's state and
// RK4 accumulator (Cahn-Hilliard: k1 and the held potential). These stay
// in registers (1 or 2 cells a thread, in blocks of up to 1,024
// threads), or, past what a block's threads hold in registers (the large
// end of the range), in device memory that only their owner reads and
// writes (scratch the wrapper allocates), loaded for each cell and stage;
// where both fit, registers were faster (21^3 Burgers on 16 blocks 12.1
// against 16.0 us a step; 4 cells a thread in blocks of 512, which holds
// no block that 2 cells in 1,024 do not, was slower at every shape swept
// and is not built). A
// batch of states is the grid: one cluster per state (Parareal's fine
// ends, a trajectory's leading axis). The trajectory is stored in the JAX
// package's (..., steps, D, H, W, n) layout, each thread writing its
// cells' n values. The host plans the cluster size and cells a thread
// from a table measured on the card (tools/k9_plan_sweep.py;
// ops/fused_system_3d.py make_cluster_plan_3d: 16 blocks for the main
// path's single states, 8 x 2 cells for Parareal's 8 fine ends, which
// 16-block clusters would run in two waves), for a batch asking
// fused_system_3d_max_active_clusters how many clusters the card holds at
// once, and refuses, without launching, a cluster the card cannot place
// (cudaOccupancyMaxActiveClusters). What held and what did not of the
// starting points: slabs along axis 0 held (a 2D split over axes 0 and 1
// was not built: at 21^3 it would cut the largest block from 882 to 756
// cells for twice the slab faces through DSMEM); the barriers still take
// most of a step (the 2-plane blocks beside 1-plane ones; the split after
// the redesign); the TPU kernels' (8, 128) padding and DMA
// double-buffering are not carried over, nor are TMA slab loads (the
// split puts the slab load at 3-6 us a solve).
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// The step split (tools/k9_step_split.py builds this source with
// -DK9_STEP_SPLIT): lane 0 of every warp of every block of the first
// state's cluster adds the clock64() cycles it spends in each segment
// (kSplit* below) to a per-warp sum in shared memory, and writes the sums
// to k9_split_sums at its exit, kSplitSegments a warp, (rank, warp)
// major; the first thread of every block records the globaltimer at its
// entry (atomicMin) and exit (atomicMax) in k9_split_span. A mark closes
// the segment that ends there once the value named in it has arrived (its
// clock read waits on a predicate of that value), so a load's latency
// lands in the segment that issued it. Without the macro the marks
// compile to nothing.
constexpr int kSplitSetup = 0;
constexpr int kSplitLoads = 1;
constexpr int kSplitFaces = 2;
constexpr int kSplitArithmetic = 3;
constexpr int kSplitUpdate = 4;
constexpr int kSplitBarriers = 5;
constexpr int kSplitFrames = 6;
constexpr int kSplitLoadStore = 7;
constexpr int kSplitSegments = 8;
#ifdef K9_STEP_SPLIT
__device__ long long* k9_split_sums;
__device__ unsigned long long* k9_split_span;
__shared__ long long k9_split_acc[kSplitSegments][32];
__shared__ long long k9_split_last[32];
__device__ __forceinline__ unsigned long long k9_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void k9_split_mark(int segment, float after) {
  if ((threadIdx.x & 31) == 0 && after == after) {
    const int warp = threadIdx.x >> 5;
    const long long now = clock64();
    k9_split_acc[segment][warp] += now - k9_split_last[warp];
    k9_split_last[warp] = now;
  }
}
#define K9_SPLIT_BEGIN                                              \
  if (threadIdx.x == 0 && k9_split_span != nullptr) {               \
    atomicMin(&k9_split_span[0], k9_global_ns());                   \
  }                                                                 \
  if ((threadIdx.x & 31) == 0) {                                    \
    for (int s = 0; s < kSplitSegments; ++s) {                      \
      k9_split_acc[s][threadIdx.x >> 5] = 0;                        \
    }                                                               \
    k9_split_last[threadIdx.x >> 5] = clock64();                    \
  }
#define K9_SPLIT_MARK(segment, after) k9_split_mark(segment, after)
#define K9_SPLIT_END(rank, cluster_size)                            \
  if (blockIdx.x < (cluster_size) && (threadIdx.x & 31) == 0 &&     \
      k9_split_sums != nullptr) {                                   \
    const int warp = threadIdx.x >> 5;                              \
    for (int s = 0; s < kSplitSegments; ++s) {                      \
      k9_split_sums[((rank) * 32 + warp) * kSplitSegments + s] =    \
          k9_split_acc[s][warp];                                    \
    }                                                               \
  }                                                                 \
  __syncthreads();                                                  \
  if (threadIdx.x == 0 && k9_split_span != nullptr) {               \
    atomicMax(&k9_split_span[1], k9_global_ns());                   \
  }
#else
#define K9_SPLIT_BEGIN
#define K9_SPLIT_MARK(segment, after)
#define K9_SPLIT_END(rank, cluster_size)
#endif

namespace {

// the most threads a block has (64 registers a thread)
constexpr int kMaxThreads = 1024;
constexpr int kMaxClusterSize = 16;
constexpr size_t kMaxSharedBytes = 227 * 1024;

struct Params {
  int depth;
  int height;
  int width;
  int n_steps;
  int cluster_size;
  // the largest number of planes one block holds
  int slab;
  // cells a thread (for the instances that keep them in device memory)
  int cells;
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
  // cells in device memory: the threads' cells, kSlotWords<n> floats each
  float* scratch;
  const uint8_t* dir_mask;
  const float* dir_vals;
  Faces faces;
  Params p;
};

// This block's part of the volume: planes [z_begin, z_begin + planes) of
// axis 0, kept in shared memory as n component slabs of `stride` values,
// its own planes from `base` on (after a halo plane where there is one).
struct Slab {
  int z_begin;
  int planes;
  int hw;
  int stride;
  int base;
  int cells;
  // the offset of the slab's last plane
  int last_plane;
};

// A stage input as this block sees it. With halo planes (the RK4
// families' instances that keep cells in registers) the neighbouring
// blocks have pushed their edge planes into this block's halo planes, so
// every neighbour is read from its own shared memory; without them (cells
// in device memory, at the large end of the range, where a slab and two
// halo planes do not fit a block; and Cahn-Hilliard) the planes across a
// slab edge are read from the neighbouring blocks' shared memory through
// distributed shared memory. Pushing took 21^3 Burgers from 13.7 to 12.2
// us a step on 16 blocks and the B = 8 fine ends from 21.3 to 19.3 on 8,
// but 31^3 Cahn-Hilliard from 5.8 to 6.3 (tools/k9_plan_sweep.py on a
// pulling and a pushing build, NVIDIA H100 80GB HBM3 at 700 W).
struct HaloVolume {
  static constexpr bool kHalo = true;
  const float* local;
};
struct PullVolume {
  static constexpr bool kHalo = false;
  const float* local;
  // the previous block's last plane and the next block's first plane, of
  // component 0 (components follow at `stride`), or nullptr at the ends
  const float* prev;
  const float* next;
};

// Where a stage's output goes: the block's own slabs and, with halo
// planes, the same slabs of the blocks before and after it (null at the
// ends), whose halo planes receive this block's first and last planes;
// prev_halo is the offset of the previous block's upper halo plane.
struct Target {
  float* local;
  float* prev;
  float* next;
  int prev_halo;
};

// A barrier over the block, or over every block of the cluster (which
// also makes each block's shared-memory writes before it visible to the
// others).
__device__ __forceinline__ void barrier(int cluster_size) {
  if (cluster_size > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// A cell's flags: on the grid's lower / upper face of axis a (bits 2a and
// 2a + 1), on the slab's first plane with a block before it or its last
// with a block after it, a real cell (slots past the slab's cells are
// not), Dirichlet-fixed per component (from kDirichletShift) and the
// Neumann mask of the face it lies on, per axis and component (from
// kNeumannShift: bit axis * n + comp).
constexpr unsigned kFaceBits = 0x3fu;
constexpr unsigned kFirstPlane = 1u << 6;
constexpr unsigned kLastPlane = 1u << 7;
constexpr unsigned kValid = 1u << 8;
constexpr int kDirichletShift = 10;
constexpr int kNeumannShift = 16;

__host__ __device__ constexpr unsigned lower_face(int axis) {
  return 1u << (2 * axis);
}
__host__ __device__ constexpr unsigned upper_face(int axis) {
  return 2u << (2 * axis);
}

// One cell a thread owns: its index in the slab, its flags, its state,
// its RK4 accumulator (Cahn-Hilliard: k1 and D1(potential)), its
// Dirichlet values and the Neumann values of the faces it lies on (entry
// axis * N + comp).
template <int N>
struct Slot {
  int lc;
  unsigned flags;
  float y[N];
  float acc[N];
  float dv[N];
  float fg[3 * N];
};

// the floats a slot takes in device memory
template <int N>
constexpr int kSlotWords = 2 + 6 * N;

// One component's value at a cell and its six neighbours, zero outside.
struct Neighbours {
  float c;
  float lo[3];
  float hi[3];
};

// FACES: the cell may lie on a face of the grid, so each neighbour is
// tested; otherwise none is (the interior cells' path), save, without
// halo planes, the slab edges.
template <bool FACES, class V, int N>
__device__ __forceinline__ Neighbours fetch(const V& v, int comp,
                                            const Slot<N>& sl, const Slab& s,
                                            const Params& p) {
  const unsigned f = sl.flags;
  const int offset = comp * s.stride;
  const float* slab = v.local + offset + s.base;
  const int lc = sl.lc;
  Neighbours n;
  n.c = slab[lc];
  if constexpr (V::kHalo) {
    n.lo[0] = (FACES && (f & lower_face(0))) ? 0.0f : slab[lc - s.hw];
    n.hi[0] = (FACES && (f & upper_face(0))) ? 0.0f : slab[lc + s.hw];
  } else {
    if (FACES && (f & lower_face(0))) {
      n.lo[0] = 0.0f;
    } else {
      n.lo[0] = (f & kFirstPlane) ? v.prev[offset + lc] : slab[lc - s.hw];
    }
    if (FACES && (f & upper_face(0))) {
      n.hi[0] = 0.0f;
    } else {
      n.hi[0] = (f & kLastPlane) ? v.next[offset + lc - s.last_plane]
                                 : slab[lc + s.hw];
    }
  }
  n.lo[1] = (FACES && (f & lower_face(1))) ? 0.0f : slab[lc - p.width];
  n.hi[1] = (FACES && (f & upper_face(1))) ? 0.0f : slab[lc + p.width];
  n.lo[2] = (FACES && (f & lower_face(2))) ? 0.0f : slab[lc - 1];
  n.hi[2] = (FACES && (f & upper_face(2))) ? 0.0f : slab[lc + 1];
  K9_SPLIT_MARK(kSplitLoads, n.c + n.lo[0] + n.hi[0] + n.lo[1] + n.hi[1] +
                                 n.lo[2] + n.hi[2]);
  return n;
}

// The Neumann mask of the cell's face of `axis`, component `comp`, as
// 0 or 1.
template <int N>
__device__ __forceinline__ float neumann_mask(const Slot<N>& sl, int axis,
                                              int comp) {
  return ((sl.flags >> (kNeumannShift + axis * N + comp)) & 1u) ? 1.0f
                                                                : 0.0f;
}

// _StencilHelpers3D.laplacian of component `comp`.
template <bool FACES, int N>
__device__ __forceinline__ float laplacian(const Neighbours& n, int comp,
                                           const Slot<N>& sl,
                                           const Params& p) {
  float lap = (n.lo[0] - 2.0f * n.c + n.hi[0]) * p.inv_dx_sqr[0];
  lap = lap + (n.lo[1] - 2.0f * n.c + n.hi[1]) * p.inv_dx_sqr[1];
  lap = lap + (n.lo[2] - 2.0f * n.c + n.hi[2]) * p.inv_dx_sqr[2];
  K9_SPLIT_MARK(kSplitArithmetic, lap);
  if constexpr (FACES) {
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      if (sl.flags & lower_face(axis)) {
        // ghost = inner neighbour - 2 dx g
        const float ghost =
            neumann_mask(sl, axis, comp) *
            (n.hi[axis] - p.two_dx[axis] * sl.fg[axis * N + comp]);
        lap = lap + ghost * p.inv_dx_sqr[axis];
      } else if (sl.flags & upper_face(axis)) {
        // ghost = inner neighbour + 2 dx g
        const float ghost =
            neumann_mask(sl, axis, comp) *
            (n.lo[axis] + p.two_dx[axis] * sl.fg[axis * N + comp]);
        lap = lap + ghost * p.inv_dx_sqr[axis];
      }
    }
    K9_SPLIT_MARK(kSplitFaces, lap);
  }
  return lap;
}

// _StencilHelpers3D.gradient along `axis` of component `comp`.
template <bool FACES, int N>
__device__ __forceinline__ float gradient(int axis, const Neighbours& n,
                                          int comp, const Slot<N>& sl,
                                          const Params& p) {
  float g = (n.hi[axis] - n.lo[axis]) * p.inv_two_dx[axis];
  K9_SPLIT_MARK(kSplitArithmetic, g);
  if constexpr (FACES) {
    if (sl.flags & (lower_face(axis) | upper_face(axis))) {
      const float m = neumann_mask(sl, axis, comp);
      g = m * sl.fg[axis * N + comp] + (1.0f - m) * g;
    }
    K9_SPLIT_MARK(kSplitFaces, g);
  }
  return g;
}

// The right-hand sides of the JAX package's _make_rhs_builder_3d, one
// functor per family: rhs() writes every component's value at one cell.
struct Diffusion3D {
  static constexpr bool kHalo = true;
  static constexpr int kComponents = 1;
  static constexpr bool kRK4 = true;
  template <bool FACES, class V>
  static __device__ __forceinline__ void rhs(const V& v,
                                             const Slot<1>& sl,
                                             const Slab& s, const Params& p,
                                             float* out) {
    const Neighbours n = fetch<FACES>(v, 0, sl, s, p);
    out[0] = p.coefficient * laplacian<FACES>(n, 0, sl, p);
    K9_SPLIT_MARK(kSplitArithmetic, out[0]);
  }
};

struct ConvectionDiffusion3D {
  static constexpr bool kHalo = true;
  static constexpr int kComponents = 1;
  static constexpr bool kRK4 = true;
  template <bool FACES, class V>
  static __device__ __forceinline__ void rhs(const V& v,
                                             const Slot<1>& sl,
                                             const Slab& s, const Params& p,
                                             float* out) {
    const Neighbours n = fetch<FACES>(v, 0, sl, s, p);
    float result = p.coefficient * laplacian<FACES>(n, 0, sl, p);
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      if (p.velocity_mask & (1 << axis)) {
        result =
            result - p.velocity[axis] * gradient<FACES>(axis, n, 0, sl, p);
      }
    }
    out[0] = result;
    K9_SPLIT_MARK(kSplitArithmetic, result);
  }
};

struct Wave3D {
  static constexpr bool kHalo = true;
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = true;
  template <bool FACES, class V>
  static __device__ __forceinline__ void rhs(const V& v,
                                             const Slot<2>& sl,
                                             const Slab& s, const Params& p,
                                             float* out) {
    const Neighbours n = fetch<FACES>(v, 0, sl, s, p);
    out[0] = v.local[s.stride + s.base + sl.lc];
    K9_SPLIT_MARK(kSplitLoads, out[0]);
    out[1] = p.coefficient * laplacian<FACES>(n, 0, sl, p);
    K9_SPLIT_MARK(kSplitArithmetic, out[1]);
  }
};

struct Burgers3D {
  static constexpr bool kHalo = true;
  static constexpr int kComponents = 3;
  static constexpr bool kRK4 = true;
  template <bool FACES, class V>
  static __device__ __forceinline__ void rhs(const V& v,
                                             const Slot<3>& sl,
                                             const Slab& s, const Params& p,
                                             float* out) {
    const float* centre = v.local + s.base + sl.lc;
    const float y_0 = centre[0];
    const float y_1 = centre[s.stride];
    const float y_2 = centre[2 * s.stride];
    K9_SPLIT_MARK(kSplitLoads, y_0 + y_1 + y_2);
#pragma unroll
    for (int comp = 0; comp < kComponents; ++comp) {
      const Neighbours n = fetch<FACES>(v, comp, sl, s, p);
      out[comp] = p.coefficient * laplacian<FACES>(n, comp, sl, p) -
                  y_0 * gradient<FACES>(0, n, comp, sl, p) -
                  y_1 * gradient<FACES>(1, n, comp, sl, p) -
                  y_2 * gradient<FACES>(2, n, comp, sl, p);
      K9_SPLIT_MARK(kSplitArithmetic, out[comp]);
    }
  }
};

// Cahn-Hilliard has its own step (see the header); no rhs(). Its two
// light stages read across slab edges rather than push into halo planes
// (see HaloVolume).
struct CahnHilliard3D {
  static constexpr bool kHalo = false;
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

// The threads' cells in device memory (cells == 0 instances): this
// block's slots, `slots` apart field by field (kSlotWords fields), slot
// c * blockDim.x + threadIdx.x the thread's c-th cell.
struct Memory {
  float* base;
  int slots;
};

template <int N>
__device__ __forceinline__ void store_slot(const Memory& m, int q,
                                           const Slot<N>& sl) {
  float* f = m.base + q;
  const int k = m.slots;
  f[0] = __int_as_float(sl.lc);
  f[k] = __uint_as_float(sl.flags);
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    f[(2 + comp) * k] = sl.y[comp];
    f[(2 + N + comp) * k] = sl.acc[comp];
    f[(2 + 2 * N + comp) * k] = sl.dv[comp];
  }
#pragma unroll
  for (int e = 0; e < 3 * N; ++e) f[(2 + 3 * N + e) * k] = sl.fg[e];
}

// Loads slot q's cell: its index, flags, state and accumulator, and its
// Dirichlet and Neumann values where its flags say it has any.
template <int N>
__device__ __forceinline__ void load_slot(const Memory& m, int q,
                                          Slot<N>& sl) {
  const float* f = m.base + q;
  const int k = m.slots;
  sl.lc = __float_as_int(f[0]);
  sl.flags = __float_as_uint(f[k]);
  if (!(sl.flags & kValid)) return;
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    sl.y[comp] = f[(2 + comp) * k];
    sl.acc[comp] = f[(2 + N + comp) * k];
  }
  const bool fixed = sl.flags & (((1u << N) - 1u) << kDirichletShift);
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    sl.dv[comp] = fixed ? f[(2 + 2 * N + comp) * k] : 0.0f;
  }
  const bool face = sl.flags & kFaceBits;
#pragma unroll
  for (int e = 0; e < 3 * N; ++e) {
    sl.fg[e] = face ? f[(2 + 3 * N + e) * k] : 0.0f;
  }
}

// Writes back what a stage changes: the state and the accumulator.
template <int N>
__device__ __forceinline__ void save_slot(const Memory& m, int q,
                                          const Slot<N>& sl) {
  float* f = m.base + q;
  const int k = m.slots;
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    f[(2 + comp) * k] = sl.y[comp];
    f[(2 + N + comp) * k] = sl.acc[comp];
  }
}

// Calls body(slot) for each of the thread's cells: CELLS > 0 from the
// registers in `slots`, CELLS == 0 from device memory (`cells` a
// thread), written back after the body.
template <int N, int CELLS, class Body>
__device__ __forceinline__ void for_each_cell(
    Slot<N> (&slots)[CELLS > 0 ? CELLS : 1], const Memory& m, int cells,
    Body&& body) {
  if constexpr (CELLS > 0) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      if (slots[c].flags & kValid) body(slots[c]);
    }
  } else {
    for (int c = 0; c < cells; ++c) {
      const int q = c * blockDim.x + threadIdx.x;
      Slot<N> sl;
      load_slot(m, q, sl);
      if (sl.flags & kValid) {
        body(sl);
        save_slot(m, q, sl);
      }
    }
  }
}

template <bool FACES>
struct FaceTag {
  static constexpr bool value = FACES;
};

// Calls body(FaceTag<FACES>) with FACES known at compile time: false for
// a cell off every face of the grid (no face test, no face term), true
// otherwise. Cells come interior first, so whole warps take one path.
template <int N, class Body>
__device__ __forceinline__ void by_faces(const Slot<N>& sl, Body&& body) {
  if (sl.flags & kFaceBits) {
    body(FaceTag<true>{});
  } else {
    body(FaceTag<false>{});
  }
}

// Writes a cell's value of component `comp` of a stage's output: into the
// block's own slab and, with halo planes, a first or last plane's value
// into the neighbouring block's halo plane.
template <bool HALO, int N>
__device__ __forceinline__ void put(const Target& t, const Slab& s, int comp,
                                    const Slot<N>& sl, float value) {
  const int offset = comp * s.stride;
  t.local[offset + s.base + sl.lc] = value;
  if constexpr (HALO) {
    if (sl.flags & kFirstPlane) t.prev[offset + t.prev_halo + sl.lc] = value;
    if (sl.flags & kLastPlane) {
      t.next[offset + sl.lc - s.last_plane] = value;
    }
  }
}

// Stage STAGE (0-3) of an RK4 step at one cell, reading `in` and writing
// the cell's accumulator and its value of `next` (STAGE == 3: the new
// state, also stored as the step's frame at `frame`, the volume's frame).
template <class Equation, int STAGE, bool WRITE_TRAJECTORY, class V, int N>
__device__ __forceinline__ void rk4_cell(Slot<N>& sl, const V& in,
                                         const Target& next, const Slab& s,
                                         size_t slab_offset, const Params& p,
                                         float* frame) {
  K9_SPLIT_MARK(kSplitSetup, static_cast<float>(sl.lc));
  float k[N];
  by_faces(sl, [&](auto faces) {
    Equation::template rhs<decltype(faces)::value>(in, sl, s, p, k);
  });
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    const bool fixed = (sl.flags >> (kDirichletShift + comp)) & 1u;
    float value;
    if constexpr (STAGE == 0) {
      sl.acc[comp] = k[comp];
      value = fixed ? sl.dv[comp] : sl.y[comp] + p.half_d_t * k[comp];
    } else if constexpr (STAGE == 1) {
      sl.acc[comp] = sl.acc[comp] + 2.0f * k[comp];
      value = fixed ? sl.dv[comp] : sl.y[comp] + p.half_d_t * k[comp];
    } else if constexpr (STAGE == 2) {
      sl.acc[comp] = sl.acc[comp] + 2.0f * k[comp];
      value = fixed ? sl.dv[comp] : sl.y[comp] + p.d_t * k[comp];
    } else {
      value = fixed ? sl.dv[comp]
                    : sl.y[comp] + p.sixth_d_t * (sl.acc[comp] + k[comp]);
      sl.y[comp] = value;
    }
    put<V::kHalo>(next, s, comp, sl, value);
    K9_SPLIT_MARK(kSplitUpdate, value);
    if constexpr (STAGE == 3 && WRITE_TRAJECTORY) {
      frame[(slab_offset + sl.lc) * N + comp] = value;
      K9_SPLIT_MARK(kSplitFrames, value);
    }
  }
}

// The first Cahn-Hilliard stage at one cell: k1 and the new potential from
// the state in `in`; D1(y1) into component 1 of `next`.
template <class V, int N>
__device__ __forceinline__ void cahn_hilliard_first(Slot<N>& sl, const V& in,
                                                    const Target& next,
                                                    const Slab& s,
                                                    const Params& p) {
  K9_SPLIT_MARK(kSplitSetup, static_cast<float>(sl.lc));
  float k1, potential, y1;
  by_faces(sl, [&](auto faces) {
    constexpr bool F = decltype(faces)::value;
    const Neighbours n1 = fetch<F>(in, 1, sl, s, p);
    k1 = p.coefficient * laplacian<F>(n1, 1, sl, p);
    const Neighbours n0 = fetch<F>(in, 0, sl, s, p);
    const float y0 = n0.c;
    potential = ((y0 * y0) * y0 - y0) - p.gamma * laplacian<F>(n0, 0, sl, p);
    y1 = n1.c;
  });
  K9_SPLIT_MARK(kSplitArithmetic, potential + k1);
  const bool fixed1 = (sl.flags >> (kDirichletShift + 1)) & 1u;
  sl.acc[0] = k1;
  sl.acc[1] = fixed1 ? sl.dv[1] : potential;
  put<V::kHalo>(next, s, 1, sl, fixed1 ? sl.dv[1] : y1);
  K9_SPLIT_MARK(kSplitUpdate, sl.acc[1]);
}

// The second Cahn-Hilliard stage at one cell: d lap(D1(y1)) from component
// 1 of `in`, the new state into `next` and the step's frame.
template <bool WRITE_TRAJECTORY, class V, int N>
__device__ __forceinline__ void cahn_hilliard_second(
    Slot<N>& sl, const V& in, const Target& next, const Slab& s,
    size_t slab_offset, const Params& p, float* frame) {
  K9_SPLIT_MARK(kSplitSetup, static_cast<float>(sl.lc));
  float rest;
  by_faces(sl, [&](auto faces) {
    constexpr bool F = decltype(faces)::value;
    const Neighbours n = fetch<F>(in, 1, sl, s, p);
    rest = p.coefficient * laplacian<F>(n, 1, sl, p);
  });
  const float combined = sl.acc[0] + 5.0f * rest;
  K9_SPLIT_MARK(kSplitArithmetic, combined);
  const float y0 = ((sl.flags >> kDirichletShift) & 1u)
                       ? sl.dv[0]
                       : sl.y[0] + p.sixth_d_t * combined;
  const float y1 = sl.acc[1];
  sl.y[0] = y0;
  sl.y[1] = y1;
  put<V::kHalo>(next, s, 0, sl, y0);
  put<V::kHalo>(next, s, 1, sl, y1);
  K9_SPLIT_MARK(kSplitUpdate, y0 + y1);
  if constexpr (WRITE_TRAJECTORY) {
    frame[(slab_offset + sl.lc) * 2] = y0;
    frame[(slab_offset + sl.lc) * 2 + 1] = y1;
    K9_SPLIT_MARK(kSplitFrames, y0 + y1);
  }
}

// The cell of slot k of this block's list: its interior cells (off every
// face of the grid) plane by plane and row by row, then its cells on the
// grid's faces (the grid's first plane if the slab holds it, each inner
// plane's ring: row 0, row H - 1, then the side columns row by row, and
// the grid's last plane if the slab holds it). Sets everything the thread
// keeps of it; a slot past the slab's cells gets no flags.
template <int N>
__device__ Slot<N> make_slot(int k, const Slab& s, const Params& p,
                             const Args& a, const float* y_in, int rank) {
  Slot<N> sl;
  sl.lc = 0;
  sl.flags = 0u;
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    sl.y[comp] = 0.0f;
    sl.acc[comp] = 0.0f;
    sl.dv[comp] = 0.0f;
  }
#pragma unroll
  for (int e = 0; e < 3 * N; ++e) sl.fg[e] = 0.0f;
  if (k >= s.cells) return sl;
  const int h = p.height;
  const int w = p.width;
  const int inner_h = h - 2;
  const int inner_w = w - 2;
  const int z_end = s.z_begin + s.planes;
  const int z_lo = max(s.z_begin, 1);
  const int inner_planes = max(min(z_end, p.depth - 1) - z_lo, 0);
  const int n_interior = inner_planes * inner_h * inner_w;
  int z, i, j;
  if (k < n_interior) {
    const int plane = inner_h * inner_w;
    const int lz = k / plane;
    const int r = k - lz * plane;
    z = z_lo + lz;
    i = 1 + r / inner_w;
    j = 1 + r - (i - 1) * inner_w;
  } else {
    int q = k - n_interior;
    const int first = s.z_begin == 0 ? s.hw : 0;
    const int ring = 2 * w + 2 * inner_h;
    const int rings = inner_planes * ring;
    if (q < first) {
      z = 0;
      i = q / w;
      j = q - i * w;
    } else if ((q -= first) < rings) {
      const int lz = q / ring;
      int r = q - lz * ring;
      z = z_lo + lz;
      if (r < w) {
        i = 0;
        j = r;
      } else if ((r -= w) < w) {
        i = h - 1;
        j = r;
      } else {
        r -= w;
        i = 1 + r / 2;
        j = (r & 1) ? w - 1 : 0;
      }
    } else {
      q -= rings;
      z = p.depth - 1;
      i = q / w;
      j = q - i * w;
    }
  }
  sl.lc = (z - s.z_begin) * s.hw + i * w + j;
  unsigned flags = kValid;
  const int pos[3] = {z, i, j};
  const int size[3] = {p.depth, h, w};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    if (pos[axis] == 0) flags |= lower_face(axis);
    if (pos[axis] == size[axis] - 1) flags |= upper_face(axis);
  }
  if (z == s.z_begin && rank > 0) flags |= kFirstPlane;
  if (z == z_end - 1 && rank < p.cluster_size - 1) flags |= kLastPlane;
  const size_t volume = static_cast<size_t>(p.depth) * s.hw;
  const size_t cell = static_cast<size_t>(z) * s.hw + i * w + j;
#pragma unroll
  for (int comp = 0; comp < N; ++comp) {
    const size_t e = comp * volume + cell;
    if (a.dir_mask[e]) flags |= 1u << (kDirichletShift + comp);
    sl.dv[comp] = a.dir_vals[e];
    sl.y[comp] = y_in[cell * N + comp];
  }
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const int side = (flags & lower_face(axis))   ? 0
                     : (flags & upper_face(axis)) ? 1
                                                  : -1;
    if (side < 0) continue;
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      const int face = side * N + comp;
      const int index = axis == 0   ? (face * h + i) * w + j
                        : axis == 1 ? (face * p.depth + z) * w + j
                                    : (face * p.depth + z) * h + i;
      if (a.faces.mask[axis][index]) {
        flags |= 1u << (kNeumannShift + axis * N + comp);
      }
      sl.fg[axis * N + comp] = a.faces.vals[axis][index];
    }
  }
  sl.flags = flags;
  return sl;
}

// One cluster of p.cluster_size blocks advances state blockIdx.x /
// cluster_size of `y0` ((B, D, H, W, n), row-major) by n_steps steps.
// WRITE_TRAJECTORY: out is (B, n_steps, D, H, W, n) and receives every
// step; otherwise out is (B, D, H, W, n) and receives the end. dir_mask
// and dir_vals are the Dirichlet volumes (n, D, H, W). Each thread owns
// CELLS cells in registers, or (CELLS == 0) p.cells cells in device
// memory; slot c of thread t is cell t + c * blockDim.x of make_slot's
// list. One block a multiprocessor is asked for: kMaxThreads threads of
// at most 64 registers.
template <class Equation, int CELLS, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_system_3d_rk4_kernel(const Args a) {
  constexpr int N = Equation::kComponents;
  // halo planes where the cells are in registers (see HaloVolume)
  constexpr bool kHalo = CELLS > 0 && Equation::kHalo;
  using Volume = std::conditional_t<kHalo, HaloVolume, PullVolume>;
  K9_SPLIT_BEGIN
  const Params& p = a.p;
  const int cluster_size = p.cluster_size;
  const int rank =
      cluster_size > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                       : 0;
  const size_t b = blockIdx.x / cluster_size;

  Slab s;
  s.z_begin = rank * p.depth / cluster_size;
  s.planes = (rank + 1) * p.depth / cluster_size - s.z_begin;
  s.hw = p.height * p.width;
  s.stride = (p.slab + (kHalo ? 2 : 0)) * s.hw;
  s.base = kHalo ? s.hw : 0;
  s.cells = s.planes * s.hw;
  s.last_plane = (s.planes - 1) * s.hw;
  const size_t volume = static_cast<size_t>(p.depth) * s.hw;
  const size_t slab_offset = static_cast<size_t>(s.z_begin) * s.hw;

  // layout (shared_memory_bytes_3d in ops/fused_system_3d.py): two sets
  // of n float slabs of `stride` values, each with a halo plane before
  // and after the block's planes where there are halo planes
  extern __shared__ __align__(16) float shared[];
  float* buffer_a = shared;
  float* buffer_b = shared + N * s.stride;

  const float* y_in = a.y0 + b * volume * N;
  const int cells = CELLS > 0 ? CELLS : p.cells;
  const Memory memory = {
      a.scratch == nullptr
          ? nullptr
          : a.scratch + static_cast<size_t>(blockIdx.x) * kSlotWords<N> *
                            p.cells * blockDim.x,
      p.cells * static_cast<int>(blockDim.x)};
  Slot<N> slots[CELLS > 0 ? CELLS : 1];
  auto place = [&](const Slot<N>& sl) {
    if (!(sl.flags & kValid)) return;
#pragma unroll
    for (int comp = 0; comp < N; ++comp) {
      buffer_a[comp * s.stride + s.base + sl.lc] = sl.y[comp];
    }
  };
  if constexpr (CELLS > 0) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      slots[c] = make_slot<N>(threadIdx.x + c * blockDim.x, s, p, a, y_in,
                              rank);
      place(slots[c]);
    }
  } else {
    for (int c = 0; c < cells; ++c) {
      const int q = threadIdx.x + c * blockDim.x;
      const Slot<N> sl = make_slot<N>(q, s, p, a, y_in, rank);
      store_slot(memory, q, sl);
      place(sl);
    }
  }
  if constexpr (kHalo) {
    // the halo planes' first values come from the state itself
    for (int e = threadIdx.x; e < 2 * s.hw; e += blockDim.x) {
      const int side = e >= s.hw;
      const int ij = e - side * s.hw;
      const int z = side ? s.z_begin + s.planes : s.z_begin - 1;
      if (z < 0 || z >= p.depth) continue;
      const int plane = side ? s.planes + 1 : 0;
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        buffer_a[comp * s.stride + plane * s.hw + ij] =
            y_in[(static_cast<size_t>(z) * s.hw + ij) * N + comp];
      }
    }
  }
  // every block of the cluster has started and loaded its slab before any
  // reads or writes a neighbour's shared memory
  barrier(cluster_size);
  K9_SPLIT_MARK(kSplitLoadStore, 0.0f);

  float* prev_a = nullptr;
  float* prev_b = nullptr;
  float* next_a = nullptr;
  float* next_b = nullptr;
  // the previous block's planes
  const int prev_planes =
      rank > 0 ? s.z_begin - (rank - 1) * p.depth / cluster_size : 0;
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
  Volume in_a, in_b;
  in_a.local = buffer_a;
  in_b.local = buffer_b;
  if constexpr (!kHalo) {
    // the previous block's last plane and the next block's first
    in_a.prev = prev_a == nullptr ? nullptr : prev_a + (prev_planes - 1) * s.hw;
    in_b.prev = prev_b == nullptr ? nullptr : prev_b + (prev_planes - 1) * s.hw;
    in_a.next = next_a;
    in_b.next = next_b;
  }
  const int prev_halo = (prev_planes + 1) * s.hw;
  const Target to_a = {buffer_a, prev_a, next_a, prev_halo};
  const Target to_b = {buffer_b, prev_b, next_b, prev_halo};

  for (int step = 0; step < p.n_steps; ++step) {
    float* frame = WRITE_TRAJECTORY
                       ? a.out + (b * p.n_steps + step) * volume * N
                       : nullptr;
    if constexpr (Equation::kRK4) {
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        rk4_cell<Equation, 0, WRITE_TRAJECTORY>(sl, in_a, to_b, s,
                                                slab_offset, p, frame);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        rk4_cell<Equation, 1, WRITE_TRAJECTORY>(sl, in_b, to_a, s,
                                                slab_offset, p, frame);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        rk4_cell<Equation, 2, WRITE_TRAJECTORY>(sl, in_a, to_b, s,
                                                slab_offset, p, frame);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        rk4_cell<Equation, 3, WRITE_TRAJECTORY>(sl, in_b, to_a, s,
                                                slab_offset, p, frame);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
    } else {
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        cahn_hilliard_first(sl, in_a, to_b, s, p);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
      for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
        cahn_hilliard_second<WRITE_TRAJECTORY>(sl, in_b, to_a, s,
                                               slab_offset, p, frame);
      });
      barrier(cluster_size);
      K9_SPLIT_MARK(kSplitBarriers, 0.0f);
    }
  }
  // the loop ends on a barrier: no neighbour reads this block's shared
  // memory any more, so the block may write its end state and exit
  if constexpr (!WRITE_TRAJECTORY) {
    float* y_out = a.out + (b * volume + slab_offset) * N;
    for_each_cell<N, CELLS>(slots, memory, cells, [&](Slot<N>& sl) {
#pragma unroll
      for (int comp = 0; comp < N; ++comp) {
        y_out[static_cast<size_t>(sl.lc) * N + comp] = sl.y[comp];
      }
    });
  }
  K9_SPLIT_MARK(kSplitLoadStore, 0.0f);
  K9_SPLIT_END(rank, cluster_size)
}

template <class Equation, int CELLS>
const void* select_mode(int write_trajectory) {
  return write_trajectory
             ? reinterpret_cast<const void*>(
                   fused_system_3d_rk4_kernel<Equation, CELLS, true>)
             : reinterpret_cast<const void*>(
                   fused_system_3d_rk4_kernel<Equation, CELLS, false>);
}

// The instances: 1 or 2 cells a thread in registers, or the cells in
// device memory (cells == 0), each at up to 1,024 threads.
template <class Equation>
const void* select_cells(int cells, int write_trajectory) {
  switch (cells) {
    case 0:
      return select_mode<Equation, 0>(write_trajectory);
    case 1:
      return select_mode<Equation, 1>(write_trajectory);
    case 2:
      return select_mode<Equation, 2>(write_trajectory);
    default:
      return nullptr;
  }
}

// Checks a launch's shape and the caller's plan, picks the kernel and
// fills the launch configuration (its cluster attribute in `attribute`).
// The plan (ClusterPlan3D in ops/fused_system_3d.py) owns the slab, the
// block's threads, its cells a thread and its shared-memory bytes; they
// are checked here against the card's limits and the block's cells.
// Returns the cudaError_t (0 on success).
int configure(int equation, int batch, int depth, int height, int width,
              int write_trajectory, int cluster_size, int cells, int slab,
              int threads, int per_thread, int shared_bytes,
              const void** kernel, cudaLaunchConfig_t* config,
              cudaLaunchAttribute* attribute) {
  if (batch <= 0 || depth < 2 || height < 2 || width < 2 ||
      cluster_size < 1 || cluster_size > kMaxClusterSize ||
      depth < cluster_size || slab * cluster_size < depth ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      per_thread < 1 || (cells > 0 && per_thread != cells) ||
      static_cast<long long>(threads) * per_thread <
          static_cast<long long>(slab) * height * width ||
      shared_bytes <= 0 ||
      static_cast<size_t>(shared_bytes) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (equation) {
    case kDiffusion3D:
      *kernel = select_cells<Diffusion3D>(cells, write_trajectory);
      break;
    case kConvectionDiffusion3D:
      *kernel = select_cells<ConvectionDiffusion3D>(cells, write_trajectory);
      break;
    case kWave3D:
      *kernel = select_cells<Wave3D>(cells, write_trajectory);
      break;
    case kBurgers3D:
      *kernel = select_cells<Burgers3D>(cells, write_trajectory);
      break;
    case kCahnHilliard3D:
      *kernel = select_cells<CahnHilliard3D>(cells, write_trajectory);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (*kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t error = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
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

const char* fused_system_3d_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

#ifdef K9_STEP_SPLIT
// Points the step split's marks at `sums` (kSplitSegments long longs for
// each warp of each block of the first state's cluster, rank major, 32
// warps a block) and `span` (the launch's first entry and last exit,
// globaltimer ns), or turns them off (null).
int fused_system_3d_split_buffers(void* sums, void* span) {
  long long* sums_pointer = static_cast<long long*>(sums);
  unsigned long long* span_pointer = static_cast<unsigned long long*>(span);
  cudaError_t error = cudaMemcpyToSymbol(k9_split_sums, &sums_pointer,
                                         sizeof(sums_pointer));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaMemcpyToSymbol(k9_split_span, &span_pointer,
                                             sizeof(span_pointer)));
}

int fused_system_3d_split_segments() { return kSplitSegments; }
#endif

// How many clusters of the kernel for `equation` on a D x H x W volume
// the card holds at once (cudaOccupancyMaxActiveClusters), into
// *clusters, for the plan of cluster_size blocks of `threads` threads,
// `cells` cells a thread (0: in device memory, per_thread a thread), slabs
// of at most `slab` planes and shared_bytes of shared memory a block.
// Returns the cudaError_t (0 on success).
int fused_system_3d_max_active_clusters(int equation, int depth, int height,
                                        int width, int write_trajectory,
                                        int cluster_size, int cells, int slab,
                                        int threads, int per_thread,
                                        int shared_bytes, int* clusters) {
  const void* kernel = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int error = configure(equation, 1, depth, height, width, write_trajectory,
                        cluster_size, cells, slab, threads, per_thread,
                        shared_bytes, &kernel, &config, &attribute);
  if (error != 0) return error;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &config));
}

// Launches one cluster of cluster_size blocks (1 to 16, at most D) per
// state of y0 ((batch, D, H, W, n) float32, contiguous) on `stream` for
// the equation `equation` (see EquationId), in blocks of `threads`
// threads, each owning `cells` cells in registers (1 or 2) or, with
// cells == 0, per_thread cells in `scratch` (batch x cluster_size x
// kSlotWords<n> x threads x per_thread floats, as
// ClusterPlan3D.scratch_floats sizes it; null otherwise). Each block
// holds a slab of at most `slab` planes in shared_bytes of dynamic shared
// memory (two sets of n float slabs, shared_memory_bytes_3d in
// ops/fused_system_3d.py). write_trajectory: out is (batch, n_steps, D,
// H, W, n) and receives every step; otherwise (batch, D, H, W, n) and the
// end.
// coefficients holds, in order: d_t / 2, d_t, d_t / 6, the coefficient,
// gamma, 1 / dx_a^2, 1 / (2 dx_a), 2 dx_a and the velocity v_a (a = 0, 1,
// 2). Returns cudaErrorInvalidValue for a shape or plan the instances do
// not take (more shared memory than a block holds, too many threads, too
// few threads for the slab's cells), cudaErrorCooperativeLaunchTooLarge,
// without launching, when the card cannot place one such cluster, else
// the cudaError_t of the launch (0 on success); the caller raises on
// anything else than 0.
int fused_system_3d_rk4(int equation, const float* y0, float* out,
                        int batch, int depth, int height, int width,
                        int n_steps, int write_trajectory, int cluster_size,
                        int cells, int slab, int threads, int per_thread,
                        int shared_bytes, float* scratch,
                        const uint8_t* dir_mask, const float* dir_vals,
                        const uint8_t* face_mask_0, const float* face_vals_0,
                        const uint8_t* face_mask_1, const float* face_vals_1,
                        const uint8_t* face_mask_2, const float* face_vals_2,
                        const float* coefficients, int velocity_mask,
                        void* stream) {
  if (n_steps <= 0 || (cells == 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int error = configure(equation, batch, depth, height, width,
                        write_trajectory, cluster_size, cells, slab, threads,
                        per_thread, shared_bytes, &kernel, &config,
                        &attribute);
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
  a.y0 = y0;
  a.out = out;
  a.scratch = scratch;
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
  p.cells = per_thread;
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

  void* args[] = {&a};
  status = cudaLaunchKernelExC(&config, kernel, args);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
