// Batched forward kinematics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel egopose_tpu/physics/fk_pallas.py::_fk_kernel
// (body _fk_compute, launched by fk_batched_tpu).  For each environment,
// qpos (nq) -> world body origins xpos (nb,3), orientations xquat (nb,4),
// body coms (nb,3) and joint motion subspaces s (nd,6): the root quaternion
// normalised by max(|q|, 1e-12); the root's six rows [0; e_i] and
// [R e_i; t x R e_i]; every body from its parent, its hinges applied in
// sequence about their local axis and anchor, each hinge's row
// [axis_w; anchor_w x axis_w] taken before its rotation; coms last.
//
// What bounds it.  Per environment it moves (nq + 10 nb + 6 nd) values
// (~2.5 KB in float) and does ~9 KFLOP, so at B = 1024 the card's floor is
// the ~2.5 MB of traffic (~0.75 us).  The work is a tree walk: what takes
// the time is the latency of its dependent chain, not bytes or operations
// (and, at every batch the engine launches, the host's time of a call).
//
// Design: shorten the chain.  One warp per environment, four per block.
// - The block stages the model's tables (physics/fk.py::build_tables, a
//   flat per-hinge schedule: each hinge's qpos address, dof, axis, anchor
//   and the parent of its body, so no lookup on the chain goes through
//   another index) and each warp its environment's qpos in shared memory,
//   all loads issued at once, coalesced.
// - What does not depend on the parent is hoisted off the walk, lanes in
//   parallel: every hinge's half-angle rotation (lanes over hinges), then
//   each body's transform relative to its parent, r_b = its hinges'
//   rotations in order and t_b = body_pos with each hinge's turn about its
//   anchor (lanes over bodies), keeping each hinge's axis and anchor in the
//   parent's frame for its s row.
// - The walk composes one transform per body along its ancestor path,
//   xquat_b = xquat_0 r_a1 ... r_b, xpos_b = xpos_0 + R(...) t_a1 + ...,
//   each lane its own body, no barrier between levels.
// - Then, lanes in parallel, the s rows from each hinge's parent pose and
//   the coms; outputs are staged in shared memory and written coalesced.
// Nothing of the model is baked into the code: the tables arrive as device
// memory described by FkDims, built once per model.  No --use_fast_math:
// sinf/cosf stay accurate.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define WARPS 4

// Field order: physics/fk.py::DIM_FIELDS.
struct FkDims {
  int nb, nd, nq, nh, n_int, n_float;
  int i_path_off, i_path_idx, i_hinge_off, i_hdof, i_hqadr, i_hpar;
  int f_body_pos, f_body_ipos, f_haxis, f_hanchor;
};

__device__ inline float xsqrt(float x) { return sqrtf(x); }
__device__ inline double xsqrt(double x) { return sqrt(x); }
__device__ inline void xsincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ inline void xsincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ inline float xmax(float a, float b) { return fmaxf(a, b); }
__device__ inline double xmax(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ inline void cross3(const T* a, const T* b, T* o) {
  T x = a[1] * b[2] - a[2] * b[1];
  T y = a[2] * b[0] - a[0] * b[2];
  T z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// rotate v by the unit quaternion q (wxyz): v + w t + u x t, t = 2 u x v
template <typename T>
__device__ inline void qrot(const T* q, const T* v, T* o) {
  T t[3], c[3];
  cross3(q + 1, v, t);
  t[0] *= T(2); t[1] *= T(2); t[2] *= T(2);
  cross3(q + 1, t, c);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[0] * t[i] + c[i];
}

template <typename T>
__device__ inline void qmul(const T* a, const T* b, T* o) {
  T w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  T x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  T y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  T z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// One warp's values in shared memory, from ``p`` (T* or, for the sizes,
// size_t offsets from 0): qpos, the hinges' rotations, the bodies' parent-
// relative rotations and offsets, and the staged outputs (xpos, xquat, com
// in the outputs' layout, s with each hinge's row holding its parent-frame
// axis and anchor until the s rows are formed).
template <typename P>
struct Warp {
  P q, rh, lq, lt, xpos, xquat, com, s, end;
  __host__ __device__ Warp(P p, const FkDims& d) {
    q = p;      p += d.nq;
    rh = p;     p += 4 * d.nh;
    lq = p;     p += 4 * d.nb;
    lt = p;     p += 3 * d.nb;
    xpos = p;   p += 3 * d.nb;
    xquat = p;  p += 4 * d.nb;
    com = p;    p += 3 * d.nb;
    s = p;      p += 6 * d.nd;
    end = p;
  }
};

// Bytes of a block: the float table, WARPS warps' values, the int table.
template <typename T>
__host__ __device__ inline size_t block_bytes(const FkDims& d) {
  return ((size_t)d.n_float + WARPS * Warp<size_t>(0, d).end) * sizeof(T)
         + (size_t)d.n_int * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
fk_kernel(const FkDims d, const int* __restrict__ itab,
          const T* __restrict__ ftab, const T* __restrict__ qpos,
          T* __restrict__ xpos_o, T* __restrict__ xquat_o,
          T* __restrict__ com_o, T* __restrict__ s_o, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * WARPS + warp;
  const int nb = d.nb, nd = d.nd, nh = d.nh;
  T* sf = reinterpret_cast<T*>(smem_raw);
  const size_t per = Warp<size_t>(0, d).end;
  const Warp<T*> w(sf + d.n_float + warp * per, d);
  int* si = reinterpret_cast<int*>(sf + d.n_float + WARPS * per);

  // ---- stage the tables (the block) and qpos (each warp), coalesced -----
  for (int i = threadIdx.x; i < d.n_float; i += 32 * WARPS) sf[i] = ftab[i];
  for (int i = threadIdx.x; i < d.n_int; i += 32 * WARPS) si[i] = itab[i];
  if (env < batch)
    for (int i = lane; i < d.nq; i += 32)
      w.q[i] = qpos[(size_t)env * d.nq + i];
  __syncthreads();
  if (env >= batch) return;                 // whole warps only
  const int* path_off = si + d.i_path_off;
  const int* path_idx = si + d.i_path_idx;
  const int* hinge_off = si + d.i_hinge_off;
  const int* hdof = si + d.i_hdof;
  const int* hqadr = si + d.i_hqadr;
  const int* hpar = si + d.i_hpar;
  const T* body_pos = sf + d.f_body_pos;
  const T* body_ipos = sf + d.f_body_ipos;
  const T* haxis = sf + d.f_haxis;
  const T* hanchor = sf + d.f_hanchor;

  // ---- the root's pose; every hinge's rotation (lanes over hinges) ------
  if (lane == 0) {
    const T* q = w.q;
    T n = xsqrt(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6]);
    n = xmax(n, T(1e-12));
    for (int i = 0; i < 4; ++i) w.xquat[i] = q[3 + i] / n;
    for (int i = 0; i < 3; ++i) w.xpos[i] = q[i];
  }
  for (int h = lane; h < nh; h += 32) {
    T sn, cs;
    xsincos(T(0.5) * w.q[hqadr[h]], &sn, &cs);
    const T* a = haxis + 3 * h;
    T* r = w.rh + 4 * h;
    r[0] = cs; r[1] = a[0] * sn; r[2] = a[1] * sn; r[3] = a[2] * sn;
  }
  __syncwarp();

  // ---- each body's transform relative to its parent (lanes over bodies):
  // lq = r_1 ... r_m, lt = body_pos turned about each hinge's anchor; each
  // hinge's axis and anchor in the parent's frame into its s row ---------
  for (int b = 1 + lane; b < nb; b += 32) {
    T lq[4] = {T(1), T(0), T(0), T(0)}, lt[3], tmp[3];
    for (int j = 0; j < 3; ++j) lt[j] = body_pos[3 * b + j];
    for (int h = hinge_off[b]; h < hinge_off[b + 1]; ++h) {
      const T* c = hanchor + 3 * h;
      T* sr = w.s + 6 * hdof[h];
      qrot(lq, haxis + 3 * h, sr);                 // axis, parent frame
      qrot(lq, c, tmp);
      for (int j = 0; j < 3; ++j) sr[3 + j] = lt[j] + tmp[j];   // anchor
      T nq4[4];
      qmul(lq, w.rh + 4 * h, nq4);
      for (int j = 0; j < 4; ++j) lq[j] = nq4[j];
      qrot(lq, c, tmp);
      for (int j = 0; j < 3; ++j) lt[j] = sr[3 + j] - tmp[j];
    }
    for (int j = 0; j < 4; ++j) w.lq[4 * b + j] = lq[j];
    for (int j = 0; j < 3; ++j) w.lt[3 * b + j] = lt[j];
  }
  __syncwarp();

  // ---- the walk: each body along its ancestor path from the root --------
  for (int b = 1 + lane; b < nb; b += 32) {
    T wq[4], wt[3], tmp[3];
    for (int j = 0; j < 4; ++j) wq[j] = w.xquat[j];
    for (int j = 0; j < 3; ++j) wt[j] = w.xpos[j];
    for (int i = path_off[b]; i < path_off[b + 1]; ++i) {
      const int a = path_idx[i];
      qrot(wq, w.lt + 3 * a, tmp);
      for (int j = 0; j < 3; ++j) wt[j] += tmp[j];
      T nq4[4];
      qmul(wq, w.lq + 4 * a, nq4);
      for (int j = 0; j < 4; ++j) wq[j] = nq4[j];
    }
    for (int j = 0; j < 4; ++j) w.xquat[4 * b + j] = wq[j];
    for (int j = 0; j < 3; ++j) w.xpos[3 * b + j] = wt[j];
  }
  __syncwarp();

  // ---- s rows (the root's six, then each hinge's from its parent's pose)
  // and coms, lanes in parallel --------------------------------------------
  for (int r = lane; r < 6 + nh; r += 32) {
    T aw[3], lin[3];
    if (r < 6) {
      T* sd = w.s + 6 * r;
      if (r < 3) {
        for (int i = 0; i < 6; ++i) sd[i] = T(0);
        sd[3 + r] = T(1);
      } else {
        T e[3] = {T(0), T(0), T(0)};
        e[r - 3] = T(1);
        qrot(w.xquat, e, aw);
        cross3(w.xpos, aw, lin);
        for (int i = 0; i < 3; ++i) { sd[i] = aw[i]; sd[3 + i] = lin[i]; }
      }
      continue;
    }
    const int h = r - 6, p = hpar[h];
    T* sr = w.s + 6 * hdof[h];
    const T* pq = w.xquat + 4 * p;
    T anw[3];
    qrot(pq, sr, aw);
    qrot(pq, sr + 3, anw);
    for (int j = 0; j < 3; ++j) anw[j] += w.xpos[3 * p + j];
    cross3(anw, aw, lin);
    for (int j = 0; j < 3; ++j) { sr[j] = aw[j]; sr[3 + j] = lin[j]; }
  }
  for (int b = lane; b < nb; b += 32) {
    T c[3];
    qrot(w.xquat + 4 * b, body_ipos + 3 * b, c);
    for (int j = 0; j < 3; ++j) w.com[3 * b + j] = w.xpos[3 * b + j] + c[j];
  }
  __syncwarp();

  // ---- coalesced stores -------------------------------------------------
  const size_t e = (size_t)env;
  for (int i = lane; i < 3 * nb; i += 32) {
    xpos_o[e * 3 * nb + i] = w.xpos[i];
    com_o[e * 3 * nb + i] = w.com[i];
  }
  for (int i = lane; i < 4 * nb; i += 32) xquat_o[e * 4 * nb + i] = w.xquat[i];
  for (int i = lane; i < 6 * nd; i += 32) s_o[e * 6 * nd + i] = w.s[i];
}

static int dims_of(const int* dims_host, int ndims, FkDims* d) {
  if (ndims * (int)sizeof(int) != (int)sizeof(FkDims)) return -1;
  memcpy(d, dims_host, sizeof(FkDims));
  return 0;
}

// Opt the kernel in to the block's shared memory where it needs more than
// the 48 KB a block has without (not the humanoid: 18 KB in float, 36 KB
// in double): 0, -2 (more than a block may use) or a CUDA error code.
template <typename T>
static int prepare(const FkDims& d, size_t* bytes) {
  *bytes = block_bytes<T>(d);
  if (*bytes <= 48 * 1024) return 0;
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (*bytes > (size_t)max_optin) return -2;
  return (int)cudaFuncSetAttribute(
      fk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

template <typename T>
static int launch(const int* dims_host, int ndims, const int* itab,
                  const T* ftab, const T* qpos, T* xpos, T* xquat, T* com,
                  T* s, int batch, void* stream) {
  FkDims d;
  if (dims_of(dims_host, ndims, &d) != 0 || batch < 1) return -1;
  size_t bytes = 0;
  const int err = prepare<T>(d, &bytes);
  if (err != 0) return err;
  const int blocks = (batch + WARPS - 1) / WARPS;
  fk_kernel<T><<<blocks, 32 * WARPS, bytes, (cudaStream_t)stream>>>(
      d, itab, ftab, qpos, xpos, xquat, com, s, batch);
  return (int)cudaGetLastError();
}

#define FK_ENTRY(name, T)                                                     \
  extern "C" int name(const int* dims, int ndims, const void* itab,           \
                      const void* ftab, const void* qpos, void* xpos,         \
                      void* xquat, void* com, void* s, int batch,             \
                      void* stream) {                                         \
    return launch<T>(dims, ndims, (const int*)itab, (const T*)ftab,           \
                     (const T*)qpos, (T*)xpos, (T*)xquat, (T*)com, (T*)s,     \
                     batch, stream);                                          \
  }

FK_ENTRY(egopose_fk_f32, float)
FK_ENTRY(egopose_fk_f64, double)

// Resources for dtype (0 float, 1 double): out[0] blocks per SM, out[1]
// registers per thread, out[2] dynamic shared bytes per block, out[3] local
// (spill) bytes per thread, out[4] environments per block.
template <typename T>
static int occupancy(const int* dims_host, int ndims, int* out) {
  FkDims d;
  if (dims_of(dims_host, ndims, &d) != 0) return -1;
  size_t bytes = 0;
  int err = prepare<T>(d, &bytes);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fk_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fk_kernel<T>,
                                                    32 * WARPS, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)bytes;
  out[3] = (int)attr.localSizeBytes;
  out[4] = WARPS;
  return (int)e;
}

extern "C" int egopose_fk_occupancy(const int* dims, int ndims, int f64,
                                    int* out) {
  return f64 ? occupancy<double>(dims, ndims, out)
             : occupancy<float>(dims, ndims, out);
}
