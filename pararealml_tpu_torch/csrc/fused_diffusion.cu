// Fused RK4 kernels for single-component 2D Cartesian diffusion and
// convection-diffusion with static boundary conditions, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in ops/fused_diffusion.py:
//   K1 build_fused_diffusion_rk4_trajectory (every step stored),
//   K2 build_fused_diffusion_rk4_end (end state only; single or batched),
//   K3 build_fused_diffusion_rk4_step (one step: K1 with n_steps = 1).
// All three are launches of one pair of kernel templates, computing what
// _KernelConfig.make_rk4 computes, term for term and in the same order:
// classic k1..k4 with the Dirichlet grid applied after each stage and at
// the end, the Neumann ghost row and column corrections added after the
// interior 5-point Laplacian (rows first, then columns), and the
// constrained-derivative overrides of the central first derivatives for
// convection.
//
// What bounds it on the card: not bytes or FLOPs. The main path's grid
// is 21 x 21 (441 cells, 1.7 KB of state) and one RK4 step is ~60 FLOPs a
// cell; the 40,000-step solve is a chain of 160,000 dependent stages, so
// the limit is the issue and latency of one stage. The step split of the
// first design (every buffer in shared memory, cells dealt row-major to
// the threads; tools/k1_step_split.py, NVIDIA H100 80GB HBM3 at 700 W)
// put two thirds of a 21 x 21 step in the integer division that found
// each cell's (i, j) and in the face tests (byte masks read from shared
// memory, branches that split most warps), and a twentieth in barriers.
//
// What the design does about it. One CTA owns one state for all n_steps
// (a batch of states is the grid, one CTA each), and every per-cell
// invariant is worked out once, before the step loop: a stage has no
// integer division, no mask load and no shared-memory accumulator. Each
// thread keeps its cells' state and RK4 accumulator in registers, and a
// Dirichlet cell's state register holds its Dirichlet value from the
// start: the plain version's select D(x) = mask ? value : x becomes
// mask ? s : x, with the mask a register bit (the stage-1 input of the
// first step still holds the raw initial state, as the plain version's
// does). Face corrections are predicated adds in the plain version's
// order. Two layouts, each a plan the host picks from a measured table
// (ops/fused_diffusion.py, make_k1_plan):
//   cells   each thread owns up to CELLS cells, fixed at setup, interior
//           cells first and face cells after them (so all but one warp
//           take one path, and an interior cell's neighbour reads need no
//           test), each held in three registers: state, accumulator, and
//           one word of index and flags; only the stage input, which
//           neighbours read, goes through shared memory, in two buffers,
//           with one __syncthreads() a stage; the ghost constants that
//           face cells add are read there too (two floats at most a face
//           cell);
//   strips  on a grid of at most 32 x 32, each warp owns a row and each
//           lane a cell of it, with the stage input in registers too:
//           neighbours along axis 1 are one __shfl_up_sync and one
//           __shfl_down_sync away, the ghost constants sit in registers,
//           and each warp's row reaches the rows above and below through
//           shared memory (two alternating buffers) and one barrier a
//           stage. This holds the flagship's grid on 21 warps. The plan
//           sweep found longer bands slower (one warp of 21 rows 9x
//           slower, bands of two rows and lanes of two columns slower or
//           level), so only bands of one row are built.
// Device-memory traffic is the initial read plus either one row-major
// store per step (trajectory) or the final store (end); a trajectory of
// one state may also publish its count of finished frames once a chunk of
// steps, so that the host copies them out while it runs (progress.cuh).
// The TPU kernel's (8, 128) padding, DMA double-buffering and VMEM gates
// are not carried over. The host admits a grid while the first design's
// working set (ops/fused_diffusion.py shared_memory_bytes) fits the 227 KB
// a block can opt into; every admitted grid has a plan of the cells
// layout.
//
// Built with -fmad=false so that every multiply and add rounds as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <stddef.h>
#include <algorithm>
#include <stdint.h>

#include "progress.cuh"

// The step split (tools/k1_step_split.py builds this source with
// -DK1_STEP_SPLIT): every warp of block 0 adds the clock64() cycles it
// spends in each segment (kSplit* below) to sums in registers, which lane
// 0 writes to k1_split_sums at its exit, kSplitSegments a warp; thread 0
// of block 0 records the globaltimer at its entry and exit in
// k1_split_span. A mark closes the segment that ends there once the value
// named in it has arrived (its clock read waits on a predicate of that
// value), so a load's latency lands in the segment that issued it. The
// coarse split (-DK1_STEP_SPLIT=2) drops the face and arithmetic marks,
// whose waits cost a stage more than they measure: their time lands in
// the update segment. Without the macro the marks compile to nothing.
constexpr int kSplitSetup = 0;
constexpr int kSplitLoads = 1;
constexpr int kSplitFaces = 2;
constexpr int kSplitArithmetic = 3;
constexpr int kSplitUpdate = 4;
constexpr int kSplitBarriers = 5;
constexpr int kSplitFrames = 6;
constexpr int kSplitLoadStore = 7;
constexpr int kSplitSegments = 8;
#ifdef K1_STEP_SPLIT
__device__ long long* k1_split_sums;
__device__ unsigned long long* k1_split_span;
__device__ __forceinline__ unsigned long long k1_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct SplitClock {
  long long sum[kSplitSegments];
  long long last;
  __device__ __forceinline__ void begin() {
    if (blockIdx.x == 0 && threadIdx.x == 0 && k1_split_span != nullptr) {
      k1_split_span[0] = k1_global_ns();
    }
    for (int s = 0; s < kSplitSegments; ++s) sum[s] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int segment, float after) {
#if K1_STEP_SPLIT > 1
    if (segment == kSplitFaces || segment == kSplitArithmetic) return;
#endif
    if (after == after) {
      const long long now = clock64();
      sum[segment] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void end() {
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 &&
        k1_split_sums != nullptr) {
      for (int s = 0; s < kSplitSegments; ++s) {
        k1_split_sums[(threadIdx.x >> 5) * kSplitSegments + s] = sum[s];
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && k1_split_span != nullptr) {
      k1_split_span[1] = k1_global_ns();
    }
  }
};
#else
struct SplitClock {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int, float) {}
  __device__ __forceinline__ void end() {}
};
#endif

// The block's dynamic shared memory, addressed through this symbol and
// integer offsets (no pointer held in registers).
extern __shared__ __align__(16) float shared[];

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kLayoutCells = 0;
constexpr int kLayoutStrips = 1;
constexpr unsigned kFullMask = 0xffffffffu;

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
  // a published trajectory's chunk of frames less one (progress.cuh)
  int chunk_mask;
};

// y0 and out are (B, H, W) and (B, n_steps, H, W) or (B, H, W); the
// constraint tensors as ops/fused_diffusion.py _constraint_tensors makes
// them: the Dirichlet mask and values (H x W), the ghost rows (2 x W,
// lower then upper face of axis 0) and ghost columns (2 x H, lower then
// upper face of axis 1), each a byte mask and float values; the word a
// trajectory of one state publishes its finished frames to, or null.
struct Inputs {
  const float* y0;
  float* out;
  const uint8_t* dir_mask;
  const float* dir_vals;
  const uint8_t* grm;
  const float* grv;
  const uint8_t* gcm;
  const float* gcv;
  int* progress;
};

// The face term of one cell along one axis: whether the cell lies on a
// face of that axis, whether the face has a ghost value there (mask),
// the face's constant two_dx * ghost value, negated on the lower face so
// that the Laplacian adds neighbour + constant (x - y is x + (-y) in
// IEEE arithmetic), and the raw ghost value (the convection override).
struct Face {
  bool on;
  bool mask;
  float constant;
  float raw;
};

// d * Laplacian (minus the convection term) at a cell from its stage
// input c and its four neighbours (0.0 past the grid), with the row face
// term added before the column face term, as the plain version adds them:
// neighbour + constant where the face's mask is set, 0.0 where it is not.
// `row_neighbour` is the neighbour the row face's ghost term reads (below
// on the lower face, above on the upper), `col_neighbour` the column
// face's (right on the lower face, left on the upper).
template <bool HAS_CONVECTION>
__device__ __forceinline__ float rhs(float c, float above, float below,
                                     float left, float right,
                                     float row_neighbour, const Face& row,
                                     float col_neighbour, const Face& col,
                                     const Params& p, SplitClock& clock) {
  float lap = (above - 2.0f * c + below) * p.inv_dx0_sqr +
              (left - 2.0f * c + right) * p.inv_dx1_sqr;
  clock.mark(kSplitArithmetic, lap);
  // selects, not branches: a strip's rows stay one block of code
  const float with_row =
      lap + (row.mask ? row_neighbour + row.constant : 0.0f) * p.inv_dx0_sqr;
  lap = row.on ? with_row : lap;
  const float with_col =
      lap + (col.mask ? col_neighbour + col.constant : 0.0f) * p.inv_dx1_sqr;
  lap = col.on ? with_col : lap;
  clock.mark(kSplitFaces, lap);
  float value = p.d * lap;
  if (HAS_CONVECTION) {
    float gradient0 = (below - above) * p.inv_two_dx0;
    float gradient1 = (right - left) * p.inv_two_dx1;
    if (row.on && row.mask) gradient0 = row.raw;
    if (col.on && col.mask) gradient1 = col.raw;
    value = value - p.velocity0 * gradient0 - p.velocity1 * gradient1;
  }
  return value;
}

// One RK4 stage's update of a cell from k = d_t * rhs: the accumulator
// (k1 + 2 k2 + 2 k3, summed in the plain version's order) and the next
// stage's input D(s + k / 2), D(s + k / 2), D(s + k) or, at STAGE 4, the
// next state D(s + (acc + k4) / 6). `s` holds the Dirichlet value where
// `dirichlet` is set.
template <int STAGE>
__device__ __forceinline__ float stage_update(float& acc, float s, float k,
                                              bool dirichlet) {
  float x;
  if (STAGE == 1) {
    acc = k;
    x = s + 0.5f * k;
  } else if (STAGE == 2) {
    acc = acc + 2.0f * k;
    x = s + 0.5f * k;
  } else if (STAGE == 3) {
    acc = acc + 2.0f * k;
    x = s + k;
  } else {
    x = s + (acc + k) / 6.0f;
  }
  return dirichlet ? s : x;
}

// -- the cells layout ---------------------------------------------------

// One word a cell holds its row-major index g (bits 0-13; kNoCell for a
// slot without a cell) and its flags.
constexpr uint32_t kIndexBits = 0x3fffu;
constexpr uint32_t kNoCell = kIndexBits;
constexpr uint32_t kDirichlet = 1u << 14;
constexpr uint32_t kRowFace = 1u << 15;   // i == 0 or i == H - 1
constexpr uint32_t kUpperRow = 1u << 16;  // i == H - 1
constexpr uint32_t kColFace = 1u << 17;   // j == 0 or j == W - 1
constexpr uint32_t kUpperCol = 1u << 18;  // j == W - 1
constexpr uint32_t kRowMask = 1u << 19;   // the row face has a ghost value
constexpr uint32_t kColMask = 1u << 20;   // the column face has one

// The shared memory of the cells layout, in floats: two stage buffers of
// H x W, the column faces' signed constants and raw values by cell (H x W
// each; only face cells' entries are written and read), then the row
// faces' by column (2 x W each).
__host__ __device__ inline size_t cells_shared_floats(int height, int width) {
  return 4 * static_cast<size_t>(height) * width +
         4 * static_cast<size_t>(width);
}

// Up to two cells a thread keep their own stage input in a register too;
// more read it back from the buffer (registers for all 1,024 threads).
template <int CELLS>
struct OwnInput {
  static constexpr bool kHeld = CELLS <= 2;
  float value[kHeld ? CELLS : 1];
};

// The cells layout's shared memory offsets, in floats: the stage input
// and output buffers, then the column faces' constants and raw values by
// cell and the row faces' by column.
struct CellsShared {
  int input;
  int output;
  int col_constant;
  int col_raw;
  int row_constant;
  int row_raw;
};

template <int STAGE, int CELLS, bool HAS_CONVECTION, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void cells_stage(
    const CellsShared& at, float (&s)[CELLS], float (&acc)[CELLS],
    OwnInput<CELLS>& own, const uint32_t (&bits)[CELLS], const Params& p,
    float* frame, SplitClock& clock) {
  const int w = p.width;
  // the row faces' index shift: cell (H - 1, j) reads entry W + j
  const int upper_row_shift = (p.height - 2) * w;
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    uint32_t f = bits[k];
    // many cells a thread: keep the compiler from holding each cell's
    // addresses and face tests across stages (it would spill them)
    if (CELLS > 2) asm volatile("" : "+r"(f));
    const int g = f & kIndexBits;
    if (g == kNoCell) continue;
    const int cell = at.input + g;
    const float c = OwnInput<CELLS>::kHeld ? own.value[k] : shared[cell];
    // the right-hand side on each branch: the interior path carries no
    // face value (registers for 11 cells a thread)
    float k_value;
    if (f & (kRowFace | kColFace)) {
      // a face cell: 0.0 past the grid, and its face terms
      const bool upper_row = (f & kUpperRow) != 0;
      const bool lower_row = (f & kRowFace) != 0 && !upper_row;
      const bool upper_col = (f & kUpperCol) != 0;
      const bool lower_col = (f & kColFace) != 0 && !upper_col;
      const float above = lower_row ? 0.0f : shared[cell - w];
      const float below = upper_row ? 0.0f : shared[cell + w];
      const float left = lower_col ? 0.0f : shared[cell - 1];
      const float right = upper_col ? 0.0f : shared[cell + 1];
      clock.mark(kSplitLoads, c + above + below + left + right);
      Face row{false, false, 0.0f, 0.0f};
      Face col{false, false, 0.0f, 0.0f};
      if (f & kRowFace) {
        const int x = upper_row ? g - upper_row_shift : g;
        row = Face{true, (f & kRowMask) != 0, shared[at.row_constant + x],
                   shared[at.row_raw + x]};
      }
      if (f & kColFace) {
        col = Face{true, (f & kColMask) != 0, shared[at.col_constant + g],
                   shared[at.col_raw + g]};
      }
      clock.mark(kSplitFaces, row.constant + col.constant);
      k_value = p.d_t * rhs<HAS_CONVECTION>(
                            c, above, below, left, right,
                            upper_row ? above : below, row,
                            upper_col ? left : right, col, p, clock);
    } else {
      const float above = shared[cell - w];
      const float below = shared[cell + w];
      const float left = shared[cell - 1];
      const float right = shared[cell + 1];
      clock.mark(kSplitLoads, c + above + below + left + right);
      const Face none{false, false, 0.0f, 0.0f};
      k_value = p.d_t * rhs<HAS_CONVECTION>(c, above, below, left, right,
                                            0.0f, none, 0.0f, none, p,
                                            clock);
    }
    const float next =
        stage_update<STAGE>(acc[k], s[k], k_value, (f & kDirichlet) != 0);
    clock.mark(kSplitArithmetic, next);
    shared[at.output + g] = next;
    if (OwnInput<CELLS>::kHeld) own.value[k] = next;
    if (STAGE == 4) s[k] = next;
    clock.mark(kSplitUpdate, next);
    if (STAGE == 4 && WRITE_TRAJECTORY) {
      frame[g] = next;
      clock.mark(kSplitFrames, 0.0f);
    }
    // many cells a thread: one cell's loads at a time, so that the
    // cells' registers are all a thread holds
    if (CELLS > 4) asm volatile("" ::: "memory");
  }
}

// One CTA advances state blockIdx.x by n_steps RK4 steps; thread t owns
// the cells numbered t + k * blockDim.x (k < CELLS) of the interior-first
// order: the (H - 2) x (W - 2) interior row-major, then row 0, row H - 1,
// column 0 and column W - 1 (without their corners).
template <int CELLS, bool HAS_CONVECTION, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(kMaxThreads)
    cells_kernel(Inputs in, Params p) {
  const int h = p.height;
  const int w = p.width;
  const int cells = h * w;
  // stage buffers A and B, then the face constants
  const CellsShared a_to_b{0, cells, 2 * cells, 3 * cells, 4 * cells,
                           4 * cells + 2 * w};
  const CellsShared b_to_a{cells, 0, 2 * cells, 3 * cells, 4 * cells,
                           4 * cells + 2 * w};
  float* col_constant = shared + a_to_b.col_constant;
  float* col_raw = shared + a_to_b.col_raw;
  float* row_constant = shared + a_to_b.row_constant;
  float* row_raw = shared + a_to_b.row_raw;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  SplitClock clock;
  clock.begin();

  for (int x = tid; x < 2 * w; x += stride) {
    const float value = in.grv[x];
    row_constant[x] = x < w ? -(p.two_dx0 * value) : p.two_dx0 * value;
    row_raw[x] = value;
  }
  const float* y_in = in.y0 + b * cells;
  const int interior_width = w - 2;
  const int interior = (h - 2) * interior_width;
  float s[CELLS];
  float acc[CELLS];
  OwnInput<CELLS> own;
  uint32_t bits[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int q = tid + k * stride;
    s[k] = 0.0f;
    acc[k] = 0.0f;
    if (OwnInput<CELLS>::kHeld) own.value[k] = 0.0f;
    bits[k] = kNoCell;
    if (q >= cells) continue;
    int i;
    int j;
    if (q < interior) {
      i = 1 + q / interior_width;
      j = 1 + q - (i - 1) * interior_width;
    } else {
      const int f = q - interior;
      if (f < w) {
        i = 0;
        j = f;
      } else if (f < 2 * w) {
        i = h - 1;
        j = f - w;
      } else if (f < 2 * w + h - 2) {
        i = 1 + f - 2 * w;
        j = 0;
      } else {
        i = 1 + f - 2 * w - (h - 2);
        j = w - 1;
      }
    }
    const int g = i * w + j;
    uint32_t f = static_cast<uint32_t>(g);
    if (in.dir_mask[g]) f |= kDirichlet;
    if (i == 0 || i == h - 1) {
      f |= kRowFace;
      if (i == h - 1) f |= kUpperRow;
      if (in.grm[(i == h - 1 ? w : 0) + j]) f |= kRowMask;
    }
    if (j == 0 || j == w - 1) {
      const int x = (j == w - 1 ? h : 0) + i;
      f |= kColFace;
      if (j == w - 1) f |= kUpperCol;
      if (in.gcm[x]) f |= kColMask;
      const float value = in.gcv[x];
      col_constant[g] = j == w - 1 ? p.two_dx1 * value : -(p.two_dx1 * value);
      col_raw[g] = value;
    }
    const float y = y_in[g];
    bits[k] = f;
    if (OwnInput<CELLS>::kHeld) own.value[k] = y;
    shared[g] = y;
    // a Dirichlet cell's state holds its value: D(x) = mask ? s : x
    s[k] = (f & kDirichlet) ? in.dir_vals[g] : y;
    // many cells a thread: one cell's setup at a time
    if (CELLS > 4) asm volatile("" ::: "memory");
  }
  __syncthreads();
  clock.mark(kSplitSetup, 0.0f);

  float* out = in.out;
  for (int step = 0; step < p.n_steps; ++step) {
    float* frame = out + (b * p.n_steps + step) * cells;
    cells_stage<1, CELLS, HAS_CONVECTION, WRITE_TRAJECTORY>(
        a_to_b, s, acc, own, bits, p, frame, clock);
    __syncthreads();
    clock.mark(kSplitBarriers, 0.0f);
    cells_stage<2, CELLS, HAS_CONVECTION, WRITE_TRAJECTORY>(
        b_to_a, s, acc, own, bits, p, frame, clock);
    __syncthreads();
    clock.mark(kSplitBarriers, 0.0f);
    cells_stage<3, CELLS, HAS_CONVECTION, WRITE_TRAJECTORY>(
        a_to_b, s, acc, own, bits, p, frame, clock);
    __syncthreads();
    clock.mark(kSplitBarriers, 0.0f);
    cells_stage<4, CELLS, HAS_CONVECTION, WRITE_TRAJECTORY>(
        b_to_a, s, acc, own, bits, p, frame, clock);
    __syncthreads();
    clock.mark(kSplitBarriers, 0.0f);
    if (WRITE_TRAJECTORY && in.progress != nullptr && tid == 0) {
      frame_progress::publish_frames(in.progress, p.chunk_mask, step,
                                     p.n_steps);
    }
  }
  if (!WRITE_TRAJECTORY) {
    // the state's address, worked out here rather than held across the
    // step loop (11 cells a thread would spill it)
    unsigned state;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(state));
    float* end = in.out + static_cast<size_t>(state) * cells;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int g = bits[k] & kIndexBits;
      if (g != kNoCell) end[g] = s[k];
    }
  }
  clock.mark(kSplitLoadStore, 0.0f);
  clock.end();
}

// -- the strips layout --------------------------------------------------

// The shared memory of the strips layout on an H-row grid, in floats: two
// alternating halo buffers of every band's row (32 floats a row).
__host__ __device__ inline size_t strips_shared_floats(int height) {
  return 2 * 32 * static_cast<size_t>(height);
}

// The registers of one lane of the strips layout: its cell's state, RK4
// accumulator and stage input, its Dirichlet bit, and the terms of the
// row face and the column face it lies on (off where it lies on none).
struct Strip {
  float s;
  float acc;
  float u;
  bool dirichlet;
  Face row;
  Face col;
};

// One stage of a band (row `band` of the grid): the rows above and below
// are the neighbouring bands' rows of this stage's input, read from the
// halo buffer, and the columns left and right the neighbouring lanes'
// registers. The band then publishes its row of the next stage's input
// and waits for the other bands'.
template <int STAGE, bool HAS_CONVECTION, bool WRITE_TRAJECTORY>
__device__ __forceinline__ void strips_stage(Strip& t, const float* halo_in,
                                             float* halo_out, int band,
                                             int lane, const Params& p,
                                             float* frame,
                                             SplitClock& clock) {
  const int h = p.height;
  const int w = p.width;
  // 0.0 past the grid
  const float above = band == 0 ? 0.0f : halo_in[(band - 1) * 32 + lane];
  const float below = band == h - 1 ? 0.0f : halo_in[(band + 1) * 32 + lane];
  const float from_left = __shfl_up_sync(kFullMask, t.u, 1);
  const float from_right = __shfl_down_sync(kFullMask, t.u, 1);
  const float left = lane == 0 ? 0.0f : from_left;
  const float right = lane == w - 1 ? 0.0f : from_right;
  clock.mark(kSplitLoads, above + below + from_left + from_right);
  const float k_value =
      p.d_t * rhs<HAS_CONVECTION>(t.u, above, below, left, right,
                                  band == 0 ? below : above, t.row,
                                  lane == 0 ? right : left, t.col, p, clock);
  const float next = stage_update<STAGE>(t.acc, t.s, k_value, t.dirichlet);
  clock.mark(kSplitArithmetic, next);
  t.u = next;
  if (STAGE == 4) t.s = next;
  halo_out[band * 32 + lane] = next;
  clock.mark(kSplitUpdate, next);
  if (STAGE == 4 && WRITE_TRAJECTORY && lane < w) {
    frame[band * w + lane] = next;
    clock.mark(kSplitFrames, 0.0f);
  }
  __syncthreads();
  clock.mark(kSplitBarriers, 0.0f);
}

// One CTA advances state blockIdx.x by n_steps RK4 steps; warp i of the
// blockDim.x / 32 = H bands owns row i, lane j its column j. Lanes past
// W hold 0.0 for good (set as Dirichlet cells of value 0).
template <bool HAS_CONVECTION, bool WRITE_TRAJECTORY>
__global__ void __launch_bounds__(kMaxThreads)
    strips_kernel(Inputs in, Params p) {
  const int h = p.height;
  const int w = p.width;
  const int cells = h * w;
  const int lane = threadIdx.x & 31;
  const int band = threadIdx.x >> 5;
  const bool in_grid = lane < w;
  const int g = band * w + lane;
  const size_t b = blockIdx.x;
  SplitClock clock;
  clock.begin();

  Strip t;
  const bool dirichlet = in_grid && in.dir_mask[g] != 0;
  t.u = in_grid ? in.y0[b * cells + g] : 0.0f;
  // a Dirichlet cell's state holds its value: D(x) = mask ? s : x
  t.s = dirichlet ? in.dir_vals[g] : t.u;
  t.acc = 0.0f;
  t.dirichlet = dirichlet || !in_grid;
  // the row face: the lower in band 0, the upper in band H - 1; the
  // constant negated on the lower face
  t.row = Face{false, false, 0.0f, 0.0f};
  if (in_grid && (band == 0 || band == h - 1)) {
    const int x = (band == 0 ? 0 : w) + lane;
    const float value = in.grv[x];
    t.row = Face{true, in.grm[x] != 0,
                 band == 0 ? -(p.two_dx0 * value) : p.two_dx0 * value, value};
  }
  // the column face: the lower in lane 0, the upper in lane W - 1
  t.col = Face{false, false, 0.0f, 0.0f};
  if (lane == 0 || lane == w - 1) {
    const int x = (lane == 0 ? 0 : h) + band;
    const float value = in.gcv[x];
    t.col = Face{true, in.gcm[x] != 0,
                 lane == 0 ? -(p.two_dx1 * value) : p.two_dx1 * value, value};
  }
  // the first stage's halos: every band's row of the initial state
  float* halo_a = shared;
  float* halo_b = shared + 32 * h;
  halo_a[band * 32 + lane] = t.u;
  __syncthreads();
  clock.mark(kSplitSetup, 0.0f);

  float* out = in.out;
  for (int step = 0; step < p.n_steps; ++step) {
    float* frame = out + (b * p.n_steps + step) * cells;
    strips_stage<1, HAS_CONVECTION, WRITE_TRAJECTORY>(t, halo_a, halo_b, band,
                                                      lane, p, frame, clock);
    strips_stage<2, HAS_CONVECTION, WRITE_TRAJECTORY>(t, halo_b, halo_a, band,
                                                      lane, p, frame, clock);
    strips_stage<3, HAS_CONVECTION, WRITE_TRAJECTORY>(t, halo_a, halo_b, band,
                                                      lane, p, frame, clock);
    strips_stage<4, HAS_CONVECTION, WRITE_TRAJECTORY>(t, halo_b, halo_a, band,
                                                      lane, p, frame, clock);
    // the stage ended on the block's barrier
    if (WRITE_TRAJECTORY && in.progress != nullptr && threadIdx.x == 0) {
      frame_progress::publish_frames(in.progress, p.chunk_mask, step,
                                     p.n_steps);
    }
  }
  if (!WRITE_TRAJECTORY && in_grid) out[b * cells + g] = t.s;
  clock.mark(kSplitLoadStore, 0.0f);
  clock.end();
}

// -- instances ----------------------------------------------------------

// The cells layout's instances (cells a thread; ops/fused_diffusion.py
// CELLS_INSTANCES lists the same) and the strips layout's one.
template <bool C, bool T>
const void* cells_instance(int cells) {
  switch (cells) {
    case 1:
      return reinterpret_cast<const void*>(cells_kernel<1, C, T>);
    case 2:
      return reinterpret_cast<const void*>(cells_kernel<2, C, T>);
    case 4:
      return reinterpret_cast<const void*>(cells_kernel<4, C, T>);
    case 8:
      return reinterpret_cast<const void*>(cells_kernel<8, C, T>);
    case 11:
      return reinterpret_cast<const void*>(cells_kernel<11, C, T>);
    default:
      return nullptr;
  }
}

const void* select_kernel(int layout, int cells, int has_convection,
                          int write_trajectory) {
  if (layout == kLayoutCells) {
    if (has_convection) {
      return write_trajectory ? cells_instance<true, true>(cells)
                              : cells_instance<true, false>(cells);
    }
    return write_trajectory ? cells_instance<false, true>(cells)
                            : cells_instance<false, false>(cells);
  }
  if (layout == kLayoutStrips) {
    if (has_convection) {
      return write_trajectory
                 ? reinterpret_cast<const void*>(strips_kernel<true, true>)
                 : reinterpret_cast<const void*>(strips_kernel<true, false>);
    }
    return write_trajectory
               ? reinterpret_cast<const void*>(strips_kernel<false, true>)
               : reinterpret_cast<const void*>(strips_kernel<false, false>);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of a layout needs for an H x W
// grid: the cells layout's stage buffers and ghost constants, or the
// strips layout's halo buffers.
size_t fused_diffusion_plan_shared_bytes(int layout, int height, int width) {
  if (layout == kLayoutCells) {
    return sizeof(float) * cells_shared_floats(height, width);
  }
  return sizeof(float) * strips_shared_floats(height);
}

const char* fused_diffusion_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

// The registers a thread, local-memory bytes (spills) a thread and most
// threads a block of an instance (`cells` is ignored for the strips
// layout), as the card reports them (ptxas's counts): the larger counts
// and the fewer threads of its trajectory and end kernels. Returns the
// cudaError_t (cudaErrorInvalidValue for an instance that was not built).
int fused_diffusion_instance_attributes(int layout, int cells,
                                        int has_convection, int* registers,
                                        int* local_bytes, int* max_threads) {
  *registers = 0;
  *local_bytes = 0;
  *max_threads = kMaxThreads;
  for (int write_trajectory = 0; write_trajectory < 2; ++write_trajectory) {
    const void* kernel =
        select_kernel(layout, cells, has_convection, write_trajectory);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes attributes;
    cudaError_t error = cudaFuncGetAttributes(&attributes, kernel);
    if (error != cudaSuccess) return static_cast<int>(error);
    *registers = std::max(*registers, attributes.numRegs);
    *local_bytes =
        std::max(*local_bytes, static_cast<int>(attributes.localSizeBytes));
    *max_threads = std::min(*max_threads, attributes.maxThreadsPerBlock);
  }
  return 0;
}

#ifdef K1_STEP_SPLIT
// Points the step split's marks at `sums` (kSplitSegments long longs for
// each warp of block 0) and `span` (two globaltimer stamps), or turns
// them off (nulls).
int fused_diffusion_split_buffers(void* sums, void* span) {
  long long* sums_pointer = static_cast<long long*>(sums);
  unsigned long long* span_pointer = static_cast<unsigned long long*>(span);
  cudaError_t error = cudaMemcpyToSymbol(k1_split_sums, &sums_pointer,
                                         sizeof(sums_pointer));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaMemcpyToSymbol(k1_split_span, &span_pointer,
                                             sizeof(span_pointer)));
}

int fused_diffusion_split_segments() { return kSplitSegments; }
#endif

// Launches one CTA per state of y0 ((batch, H, W) float32, contiguous) on
// `stream`, on the plan the host picked: `layout` 0 (cells: `threads`
// threads of `cells` cells each) or 1 (strips: threads / 32 = H bands of
// one row, a lane a column; `cells` is ignored), with `shared_bytes` of
// dynamic shared memory (the plan's: checked). Returns the cudaError_t of
// the launch (0 on success), and cudaErrorInvalidValue without launching
// for a plan that does not cover the grid, names an instance that was not
// built, has more threads than a block holds or does not match its shared
// bytes, or publishes where progress.cuh does not admit it; the caller
// raises on anything but 0. A trajectory of one state with a non-null
// `progress` stores its count of finished frames there after every
// `chunk` steps (a power of two) and after the last (progress.cuh).
int fused_diffusion_rk4(const float* y0, float* out, int batch, int height,
                        int width, int n_steps, int write_trajectory,
                        int has_convection, int layout, int threads,
                        int cells, int shared_bytes, const uint8_t* dir_mask,
                        const float* dir_vals, const uint8_t* ghost_row_mask,
                        const float* ghost_row_vals,
                        const uint8_t* ghost_col_mask,
                        const float* ghost_col_vals, float d, float d_t,
                        float inv_dx0_sqr, float inv_dx1_sqr,
                        float inv_two_dx0, float inv_two_dx1, float two_dx0,
                        float two_dx1, float velocity0, float velocity1,
                        int* progress, int chunk, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  if (batch <= 0 || n_steps <= 0 || height < 3 || width < 3 ||
      !frame_progress::publication_valid(progress, chunk, batch,
                                   write_trajectory) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      shared_bytes < 0 ||
      static_cast<size_t>(shared_bytes) > kMaxSharedBytes ||
      static_cast<size_t>(shared_bytes) !=
          fused_diffusion_plan_shared_bytes(layout, height, width)) {
    return static_cast<int>(invalid);
  }
  if (layout == kLayoutCells) {
    // a cell's word holds its index in 14 bits, kNoCell excluded
    if (static_cast<long long>(threads) * cells <
            static_cast<long long>(height) * width ||
        static_cast<long long>(height) * width >= kNoCell) {
      return static_cast<int>(invalid);
    }
  } else if (layout == kLayoutStrips) {
    // a band a row, a lane a column
    if (threads != 32 * height || width > 32) {
      return static_cast<int>(invalid);
    }
  } else {
    return static_cast<int>(invalid);
  }
  const void* kernel =
      select_kernel(layout, cells, has_convection, write_trajectory);
  if (kernel == nullptr) return static_cast<int>(invalid);

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
  p.chunk_mask = progress == nullptr ? 0 : chunk - 1;
  Inputs in;
  in.y0 = y0;
  in.out = out;
  in.dir_mask = dir_mask;
  in.dir_vals = dir_vals;
  in.grm = ghost_row_mask;
  in.grv = ghost_row_vals;
  in.gcm = ghost_col_mask;
  in.gcv = ghost_col_vals;
  in.progress = progress;

  if (shared_bytes > 48 * 1024) {
    const cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  void* args[] = {&in, &p};
  const cudaError_t error =
      cudaLaunchKernel(kernel, dim3(batch), dim3(threads), args,
                       static_cast<size_t>(shared_bytes),
                       static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
