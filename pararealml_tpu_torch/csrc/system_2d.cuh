// The equation functors and stencil helpers of the 2D system kernels,
// Cartesian and polar, shared by the whole-grid kernel (K5 and K4,
// fused_system.cu) and the tiled kernel (K8, tiled_system.cu).
//
// They compute what the JAX package's _make_rhs_builder and
// _make_step_factory compute over its _StencilHelpers (ops/fused_system.py)
// and _TiledStencilHelpers (ops/tiled_system.py), term for term and in the
// same order. The two helper sets differ in one place, the Laplacian: the
// whole-grid one adds each axis's Neumann ghost term to that axis's second
// derivative before summing the two, the tiled one sums the two second
// derivatives first and then adds the ghost rows and the ghost columns. So
// the two kernels agree to float32 rounding, not bit for bit; each matches
// its own plain PyTorch version exactly.
//
// Polar meshes (r along axis 0, theta along axis 1) take the polar grids
// (PolarWholeGrid, PolarTile): the JAX package's polar _StencilHelpers
// terms with a per-row coefficient 1 / r, r = r_low + r_spacing i in
// float32 as the JAX kernel computes it (the host passes the H values):
//   lap = d2_0 + (d2_1 / r + d_0) / r, as d2_0 + (d2_1 inv_r + d_0) inv_r
//     with each axis's ghost added first;
//   gradient_1 = d_1 inv_r (after the face override);
//   the shallow-water divergence gains u inv_r.
// The JAX package has no tiled polar kernel; its polar K5 is the
// reference, so the polar tile (K8 past one CTA) keeps K5's order of
// operations and is bit for bit with the polar whole grid.
//
// Layout: a state is n component planes of `stride` floats each; a cell is
// its global row and column and its index in a plane, whose rows are `row`
// floats apart. Neumann faces are (2 faces, n components, length) masks
// and values, the lower face first: ghost rows over the W columns, ghost
// columns over the H rows (the layout of the JAX package's
// _component_constraint_tensors).

#pragma once

#include <stdint.h>

namespace system2d {

// The problem's float32 constants, in the order of the host's coefficient
// array (each rounded once from a Python float).
struct Params {
  int height;
  int width;
  float half_d_t;
  float d_t;
  float sixth_d_t;
  // Burgers: 1 / Re; wave: c^2; shallow water: the viscosity v;
  // Cahn-Hilliard: the mobility d
  float coefficient;
  // Cahn-Hilliard: gamma
  float gamma;
  // shallow water: the mean depth h, the drag b, the Coriolis f and the
  // gravity g
  float depth;
  float drag;
  float coriolis;
  float gravity;
  float inv_dx0_sqr;
  float inv_dx1_sqr;
  float inv_two_dx0;
  float inv_two_dx1;
  float two_dx0;
  float two_dx1;
};

constexpr int kCoefficients = 15;

inline Params make_params(int height, int width, const float* c) {
  Params p;
  p.height = height;
  p.width = width;
  p.half_d_t = c[0];
  p.d_t = c[1];
  p.sixth_d_t = c[2];
  p.coefficient = c[3];
  p.gamma = c[4];
  p.depth = c[5];
  p.drag = c[6];
  p.coriolis = c[7];
  p.gravity = c[8];
  p.inv_dx0_sqr = c[9];
  p.inv_dx1_sqr = c[10];
  p.inv_two_dx0 = c[11];
  p.inv_two_dx1 = c[12];
  p.two_dx0 = c[13];
  p.two_dx1 = c[14];
  return p;
}

struct Faces {
  const uint8_t* grm;
  const float* grv;
  const uint8_t* gcm;
  const float* gcv;
  int n;
  // polar grids: 1 / r of each of the H rows; unused otherwise
  const float* inv_r;
};

struct Planes {
  const float* data;
  int stride;
  int row;
};

struct Cell {
  int i;
  int j;
  int idx;
};

// One plane's value at a cell and its four neighbours.
struct Neighbours {
  float centre;
  float above;
  float below;
  float left;
  float right;
};

// The whole grid in the planes (K5): neighbours outside it read as zero by
// a bounds test; the Laplacian adds each axis's ghost before the sum.
struct WholeGrid {
  static constexpr bool kSumThenGhost = false;
  static constexpr bool kPolar = false;
  static constexpr bool kKnownFaces = false;
  static __device__ __forceinline__ Neighbours fetch(const Planes& v,
                                                     int comp,
                                                     const Cell& x,
                                                     const Params& p) {
    const float* plane = v.data + comp * v.stride;
    Neighbours n;
    n.centre = plane[x.idx];
    n.above = x.i > 0 ? plane[x.idx - v.row] : 0.0f;
    n.below = x.i < p.height - 1 ? plane[x.idx + v.row] : 0.0f;
    n.left = x.j > 0 ? plane[x.idx - 1] : 0.0f;
    n.right = x.j < p.width - 1 ? plane[x.idx + 1] : 0.0f;
    return n;
  }
};

// A tile with a halo (K8): its cells outside the grid hold zeros and a
// stage never reads past the tile's edge, so neighbours are plain reads;
// the Laplacian sums the axes first and adds the ghosts after.
struct Tile {
  static constexpr bool kSumThenGhost = true;
  static constexpr bool kPolar = false;
  static constexpr bool kKnownFaces = false;
  static __device__ __forceinline__ Neighbours fetch(const Planes& v,
                                                     int comp,
                                                     const Cell& x,
                                                     const Params&) {
    const float* plane = v.data + comp * v.stride;
    Neighbours n;
    n.centre = plane[x.idx];
    n.above = plane[x.idx - v.row];
    n.below = plane[x.idx + v.row];
    n.left = plane[x.idx - 1];
    n.right = plane[x.idx + 1];
    return n;
  }
};

// The polar whole grid (polar K5).
struct PolarWholeGrid : WholeGrid {
  static constexpr bool kPolar = true;
};

// The polar tile (polar K8): K5's order of operations, not K8's.
struct PolarTile : Tile {
  static constexpr bool kSumThenGhost = false;
  static constexpr bool kPolar = true;
};

// A cell of Grid whose faces are known at compile time (K5 groups its
// cells so that every warp takes one of these): TOP, BOTTOM, FIRST and
// LAST say whether it lies on the grid's first or last row or column.
// fetch reads no neighbour across a face it lies on and tests no other,
// and the helpers test only those faces. For such a cell it computes what
// Grid computes, operation for operation.
template <class Grid, bool TOP, bool BOTTOM, bool FIRST, bool LAST>
struct KnownFaces : Grid {
  static constexpr bool kKnownFaces = true;
  static constexpr bool kTop = TOP;
  static constexpr bool kBottom = BOTTOM;
  static constexpr bool kFirst = FIRST;
  static constexpr bool kLast = LAST;
  static __device__ __forceinline__ Neighbours fetch(const Planes& v,
                                                     int comp,
                                                     const Cell& x,
                                                     const Params&) {
    const float* plane = v.data + comp * v.stride;
    Neighbours n;
    n.centre = plane[x.idx];
    n.above = TOP ? 0.0f : plane[x.idx - v.row];
    n.below = BOTTOM ? 0.0f : plane[x.idx + v.row];
    n.left = FIRST ? 0.0f : plane[x.idx - 1];
    n.right = LAST ? 0.0f : plane[x.idx + 1];
    return n;
  }
};

// Whether a cell lies on the grid's first row (top), last row (bottom),
// first column (first) or last column (last): from its coordinates, or
// from Grid where Grid knows them.
template <class Grid>
__device__ __forceinline__ bool on_top(const Cell& x, const Params&) {
  if constexpr (Grid::kKnownFaces) {
    return Grid::kTop;
  } else {
    return x.i == 0;
  }
}

template <class Grid>
__device__ __forceinline__ bool on_bottom(const Cell& x, const Params& p) {
  if constexpr (Grid::kKnownFaces) {
    return Grid::kBottom;
  } else {
    return x.i == p.height - 1;
  }
}

template <class Grid>
__device__ __forceinline__ bool on_first(const Cell& x, const Params&) {
  if constexpr (Grid::kKnownFaces) {
    return Grid::kFirst;
  } else {
    return x.j == 0;
  }
}

template <class Grid>
__device__ __forceinline__ bool on_last(const Cell& x, const Params& p) {
  if constexpr (Grid::kKnownFaces) {
    return Grid::kLast;
  } else {
    return x.j == p.width - 1;
  }
}

// The Neumann ghost terms of component `comp` at a boundary cell, each the
// masked ghost value (the inward neighbour -/+ 2 dx times the constrained
// derivative, zero where the face is unconstrained) times 1 / dx^2.
__device__ __forceinline__ float ghost_row(const Neighbours& v, int comp,
                                           const Cell& x, const Params& p,
                                           const Faces& f, bool upper) {
  const int face = ((upper ? f.n : 0) + comp) * p.width + x.j;
  const float ghost =
      f.grm[face] ? (upper ? v.above + p.two_dx0 * f.grv[face]
                           : v.below - p.two_dx0 * f.grv[face])
                  : 0.0f;
  return ghost * p.inv_dx0_sqr;
}

__device__ __forceinline__ float ghost_col(const Neighbours& v, int comp,
                                           const Cell& x, const Params& p,
                                           const Faces& f, bool upper) {
  const int face = ((upper ? f.n : 0) + comp) * p.height + x.i;
  const float ghost =
      f.gcm[face] ? (upper ? v.left + p.two_dx1 * f.gcv[face]
                           : v.right - p.two_dx1 * f.gcv[face])
                  : 0.0f;
  return ghost * p.inv_dx1_sqr;
}

// gradient_0: the central row derivative, replaced on a boundary row by
// the constrained normal derivative where the face has one.
template <class Grid = WholeGrid>
__device__ __forceinline__ float gradient_0(const Neighbours& v, int comp,
                                            const Cell& x, const Params& p,
                                            const Faces& f) {
  float gradient = (v.below - v.above) * p.inv_two_dx0;
  if (on_top<Grid>(x, p)) {
    const int face = comp * p.width + x.j;
    if (f.grm[face]) gradient = f.grv[face];
  } else if (on_bottom<Grid>(x, p)) {
    const int face = (f.n + comp) * p.width + x.j;
    if (f.grm[face]) gradient = f.grv[face];
  }
  return gradient;
}

// gradient_1: the column derivative, likewise; times 1 / r on a polar
// grid.
template <class Grid>
__device__ __forceinline__ float gradient_1(const Neighbours& v, int comp,
                                            const Cell& x, const Params& p,
                                            const Faces& f) {
  float gradient = (v.right - v.left) * p.inv_two_dx1;
  if (on_first<Grid>(x, p)) {
    const int face = comp * p.height + x.i;
    if (f.gcm[face]) gradient = f.gcv[face];
  } else if (on_last<Grid>(x, p)) {
    const int face = (f.n + comp) * p.height + x.i;
    if (f.gcm[face]) gradient = f.gcv[face];
  }
  if constexpr (Grid::kPolar) gradient = gradient * f.inv_r[x.i];
  return gradient;
}

// _StencilHelpers.laplacian (Grid::kSumThenGhost false: each axis's
// ghost added first; with the polar metric where Grid::kPolar) or
// _TiledStencilHelpers.laplacian (true) of component `comp`.
template <class Grid>
__device__ __forceinline__ float laplacian(const Neighbours& v, int comp,
                                           const Cell& x, const Params& p,
                                           const Faces& f) {
  const float two_centre = 2.0f * v.centre;
  float d2_0 = ((v.above - two_centre) + v.below) * p.inv_dx0_sqr;
  float d2_1 = ((v.left - two_centre) + v.right) * p.inv_dx1_sqr;
  const bool top = on_top<Grid>(x, p);
  const bool bottom = on_bottom<Grid>(x, p);
  const bool first = on_first<Grid>(x, p);
  const bool last = on_last<Grid>(x, p);
  if constexpr (Grid::kSumThenGhost) {
    float lap = d2_0 + d2_1;
    if (top) lap = lap + ghost_row(v, comp, x, p, f, false);
    if (bottom) lap = lap + ghost_row(v, comp, x, p, f, true);
    if (first) lap = lap + ghost_col(v, comp, x, p, f, false);
    if (last) lap = lap + ghost_col(v, comp, x, p, f, true);
    return lap;
  }
  if (top) d2_0 = d2_0 + ghost_row(v, comp, x, p, f, false);
  if (bottom) d2_0 = d2_0 + ghost_row(v, comp, x, p, f, true);
  if (first) d2_1 = d2_1 + ghost_col(v, comp, x, p, f, false);
  if (last) d2_1 = d2_1 + ghost_col(v, comp, x, p, f, true);
  if constexpr (Grid::kPolar) {
    const float inv_r = f.inv_r[x.i];
    return d2_0 + (d2_1 * inv_r + gradient_0<Grid>(v, comp, x, p, f)) * inv_r;
  }
  return d2_0 + d2_1;
}

// Each functor with kRK4 writes the right-hand side of every component at
// one cell of `v` into `out`; the kernels run the classic RK4 template
// over it.

// The wave system: y0' = y1, y1' = c^2 lap(y0).
struct Wave2D {
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = true;
  template <class Grid>
  static __device__ __forceinline__ void rhs(const Planes& v, const Cell& x,
                                             const Params& p, const Faces& f,
                                             float* out) {
    const Neighbours y0 = Grid::fetch(v, 0, x, p);
    out[0] = v.data[v.stride + x.idx];
    out[1] = p.coefficient * laplacian<Grid>(y0, 0, x, p, f);
  }
};

// The viscous Burgers system: y_c' = nu lap(y_c) - y_0 d0(y_c) - y_1 d1(y_c).
struct Burgers2D {
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = true;
  template <class Grid>
  static __device__ __forceinline__ void rhs(const Planes& v, const Cell& x,
                                             const Params& p, const Faces& f,
                                             float* out) {
    const float y_0 = v.data[x.idx];
    const float y_1 = v.data[v.stride + x.idx];
#pragma unroll
    for (int comp = 0; comp < kComponents; ++comp) {
      const Neighbours n = Grid::fetch(v, comp, x, p);
      out[comp] =
          p.coefficient * laplacian<Grid>(n, comp, x, p, f) -
          y_0 * gradient_0<Grid>(n, comp, x, p, f) -
          y_1 * gradient_1<Grid>(n, comp, x, p, f);
    }
  }
};

// The non-conservative shallow-water system (eta, u, w), Cartesian (on a
// polar grid the gradients along axis 1 and the divergence carry 1 / r):
//   eta' = -h div(u, w) - eta du/dx0 - u deta/dx0 - eta dw/dx1 - w deta/dx1
//   u'   = v lap(u) - u du/dx0 - w du/dx1 - g deta/dx0 - b u + f w
//   w'   = v lap(w) - u dw/dx0 - w dw/dx1 - g deta/dx1 - b w - f u
struct ShallowWater2D {
  static constexpr int kComponents = 3;
  static constexpr bool kRK4 = true;
  template <class Grid>
  static __device__ __forceinline__ void rhs(const Planes& v, const Cell& x,
                                             const Params& p, const Faces& f,
                                             float* out) {
    const Neighbours n_eta = Grid::fetch(v, 0, x, p);
    const Neighbours n_u = Grid::fetch(v, 1, x, p);
    const Neighbours n_w = Grid::fetch(v, 2, x, p);
    const float eta = n_eta.centre;
    const float u = n_u.centre;
    const float w = n_w.centre;
    const float d_eta_0 = gradient_0<Grid>(n_eta, 0, x, p, f);
    const float d_eta_1 = gradient_1<Grid>(n_eta, 0, x, p, f);
    const float d_u_0 = gradient_0<Grid>(n_u, 1, x, p, f);
    const float d_u_1 = gradient_1<Grid>(n_u, 1, x, p, f);
    const float d_w_0 = gradient_0<Grid>(n_w, 2, x, p, f);
    const float d_w_1 = gradient_1<Grid>(n_w, 2, x, p, f);
    float div = d_u_0 + d_w_1;
    // the polar divergence's u / r
    if constexpr (Grid::kPolar) div = div + u * f.inv_r[x.i];
    out[0] = (((-p.depth * div - eta * d_u_0) - u * d_eta_0) -
              eta * d_w_1) -
             w * d_eta_1;
    out[1] = ((((p.coefficient *
                     laplacian<Grid>(n_u, 1, x, p, f) -
                 u * d_u_0) -
                w * d_u_1) -
               p.gravity * d_eta_0) -
              p.drag * u) +
             p.coriolis * w;
    out[2] = ((((p.coefficient *
                     laplacian<Grid>(n_w, 2, x, p, f) -
                 u * d_w_0) -
                w * d_w_1) -
               p.gravity * d_eta_1) -
              p.drag * w) -
             p.coriolis * u;
  }
};

// Cahn-Hilliard has its own step, in two stages (the JAX package's
// step factory): y1, the chemical potential, is held through RK4's stages
// on y0' = d lap(y1), so k2 = k3 = k4 = d lap(D1(y1)), and
//   y0' = D0(y0 + (d_t/6) (k1 + 5 k_rest)),
//   y1' = D1(((y0 y0) y0 - y0) - gamma lap(y0)) from the step-initial y0.
struct CahnHilliard2D {
  static constexpr int kComponents = 2;
  static constexpr bool kRK4 = false;

  // the first stage at one cell of the state: k1 and the new potential
  // (before its Dirichlet override)
  template <class Grid>
  static __device__ __forceinline__ void first(const Planes& v,
                                               const Cell& x,
                                               const Params& p,
                                               const Faces& f, float* k1,
                                               float* potential) {
    const Neighbours n1 = Grid::fetch(v, 1, x, p);
    *k1 = p.coefficient * laplacian<Grid>(n1, 1, x, p, f);
    const Neighbours n0 = Grid::fetch(v, 0, x, p);
    const float y0 = n0.centre;
    *potential = ((y0 * y0) * y0 - y0) -
                 p.gamma * laplacian<Grid>(n0, 0, x, p, f);
  }

  // the second stage at one cell of the planes holding D1(y1) as their
  // component 1: d lap(D1(y1))
  template <class Grid>
  static __device__ __forceinline__ float k_rest(const Planes& v,
                                                 const Cell& x,
                                                 const Params& p,
                                                 const Faces& f) {
    const Neighbours n = Grid::fetch(v, 1, x, p);
    return p.coefficient * laplacian<Grid>(n, 1, x, p, f);
  }
};

// The equation numbers the host passes (ops/fused_system.py
// _EQUATION_IDS).
enum EquationId {
  kWave2D = 0,
  kBurgers2D = 1,
  kShallowWater2D = 2,
  kCahnHilliard2D = 3,
};

}  // namespace system2d
