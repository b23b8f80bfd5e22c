// Batched forward kinematics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel egopose_tpu/physics/fk_pallas.py::_fk_kernel
// (body _fk_compute, launched by fk_batched_tpu).  For each environment,
// qpos (nq) -> world body origins xpos (nb,3), orientations xquat (nb,4),
// body coms (nb,3) and joint motion subspaces s (nd,6), in _fk_compute's
// order: the root quaternion normalised by max(|q|, 1e-12); the root's six
// rows [0; e_i] and [R e_i; t x R e_i]; then every body from its parent,
// its hinges applied in sequence about their local axis and anchor, each
// hinge's row [axis_w; anchor_w x axis_w] taken before its rotation; coms
// last.
//
// Design.  One warp per environment, four per block.  The tree is walked
// level by level: the warp's lanes take the bodies of one level (the
// humanoid has 8 levels of at most 3 bodies), each walking its body's
// hinges, and a __syncwarp separates the levels.  The warp keeps its
// bodies' world poses (7 nb values) in shared memory; s rows, poses and
// coms are written straight to device memory.  The model's tables (parent,
// levels, per-body hinge lists, qpos addresses, body offsets, axes and
// anchors) arrive as device memory described by FkDims, which the Python
// wrapper (physics/fk.py) builds once per model: nothing of the model is
// baked into the code.
//
// What bounds it.  Per environment it moves (nq + 10 nb + 6 nd) values
// (~2.0 KB in float) and does ~140 flops per hinge plus ~70 per body
// (~10 KFLOP), so at B = 1024 the card's floor is the ~2 MB of traffic
// (~0.6 us).  The kernel is latency-bound on the tree's depth: each level
// is a chain of dependent quaternion products and sines, one level after
// the other.  No --use_fast_math: sinf/cosf stay accurate.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define WARPS 4

struct FkDims {
  int nb, nd, nq, nlevel;
  int i_parent, i_lvl_off, i_lvl_body, i_bdof_off, i_bdof_idx, i_qadr;
  int f_body_pos, f_body_ipos, f_axis, f_anchor;
};

__device__ inline float xsqrt(float x) { return sqrtf(x); }
__device__ inline double xsqrt(double x) { return sqrt(x); }
__device__ inline float xsin(float x) { return sinf(x); }
__device__ inline double xsin(double x) { return sin(x); }
__device__ inline float xcos(float x) { return cosf(x); }
__device__ inline double xcos(double x) { return cos(x); }
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

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
fk_kernel(const FkDims d, const int* __restrict__ itab,
          const T* __restrict__ ftab, const T* __restrict__ qpos,
          T* __restrict__ xpos_o, T* __restrict__ xquat_o,
          T* __restrict__ com_o, T* __restrict__ s_o, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * WARPS + warp;
  if (env >= batch) return;                 // whole warps only
  const int nb = d.nb, nd = d.nd;
  T* wq = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 7 * nb;  // 4 nb
  T* wt = wq + 4 * nb;                                              // 3 nb
  const int* parent = itab + d.i_parent;
  const int* lvl_off = itab + d.i_lvl_off;
  const int* lvl_body = itab + d.i_lvl_body;
  const int* bdof_off = itab + d.i_bdof_off;
  const int* bdof_idx = itab + d.i_bdof_idx;
  const int* qadr = itab + d.i_qadr;
  const T* q = qpos + (size_t)env * d.nq;
  T* so = s_o + (size_t)env * nd * 6;

  if (lane == 0) {
    T n = xsqrt(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6]);
    n = xmax(n, T(1e-12));
    for (int i = 0; i < 4; ++i) wq[i] = q[3 + i] / n;
    for (int i = 0; i < 3; ++i) wt[i] = q[i];
  }
  __syncwarp();
  if (lane < 6) {
    T* sd = so + 6 * lane;
    if (lane < 3) {
      for (int i = 0; i < 6; ++i) sd[i] = T(0);
      sd[3 + lane] = T(1);
    } else {
      T e[3] = {T(0), T(0), T(0)};
      e[lane - 3] = T(1);
      T aw[3], lin[3];
      qrot(wq, e, aw);
      cross3(wt, aw, lin);
      for (int i = 0; i < 3; ++i) { sd[i] = aw[i]; sd[3 + i] = lin[i]; }
    }
  }
  for (int lv = 0; lv < d.nlevel; ++lv) {
    for (int i = lvl_off[lv] + lane; i < lvl_off[lv + 1]; i += 32) {
      const int b = lvl_body[i], p = parent[b];
      T bq[4], bt[3], tmp[3];
      for (int j = 0; j < 4; ++j) bq[j] = wq[4 * p + j];
      qrot(bq, ftab + d.f_body_pos + 3 * b, tmp);
      for (int j = 0; j < 3; ++j) bt[j] = wt[3 * p + j] + tmp[j];
      for (int h = bdof_off[b]; h < bdof_off[b + 1]; ++h) {
        const int dof = bdof_idx[h];
        const T* a = ftab + d.f_axis + 3 * dof;
        const T* c = ftab + d.f_anchor + 3 * dof;
        T aw[3], anw[3], lin[3];
        qrot(bq, a, aw);
        qrot(bq, c, tmp);
        for (int j = 0; j < 3; ++j) anw[j] = bt[j] + tmp[j];
        cross3(anw, aw, lin);
        for (int j = 0; j < 3; ++j) {
          so[6 * dof + j] = aw[j];
          so[6 * dof + 3 + j] = lin[j];
        }
        const T half = T(0.5) * q[qadr[dof]];
        const T sn = xsin(half);
        const T r[4] = {xcos(half), a[0] * sn, a[1] * sn, a[2] * sn};
        T nq4[4];
        qmul(bq, r, nq4);
        for (int j = 0; j < 4; ++j) bq[j] = nq4[j];
        qrot(bq, c, tmp);
        for (int j = 0; j < 3; ++j) bt[j] = anw[j] - tmp[j];
      }
      for (int j = 0; j < 4; ++j) wq[4 * b + j] = bq[j];
      for (int j = 0; j < 3; ++j) wt[3 * b + j] = bt[j];
    }
    __syncwarp();
  }
  const size_t o3 = (size_t)env * nb * 3, o4 = (size_t)env * nb * 4;
  for (int b = lane; b < nb; b += 32) {
    T c[3];
    qrot(wq + 4 * b, ftab + d.f_body_ipos + 3 * b, c);
    for (int j = 0; j < 3; ++j) {
      xpos_o[o3 + 3 * b + j] = wt[3 * b + j];
      com_o[o3 + 3 * b + j] = wt[3 * b + j] + c[j];
    }
    for (int j = 0; j < 4; ++j) xquat_o[o4 + 4 * b + j] = wq[4 * b + j];
  }
}

template <typename T>
static int launch(const int* dims_host, int ndims, const int* itab,
                  const T* ftab, const T* qpos, T* xpos, T* xquat, T* com,
                  T* s, int batch, void* stream) {
  if (ndims * (int)sizeof(int) != (int)sizeof(FkDims) || batch < 1) return -1;
  FkDims d;
  memcpy(&d, dims_host, sizeof(FkDims));
  const size_t bytes = (size_t)WARPS * 7 * d.nb * sizeof(T);
  if (bytes > 48 * 1024) return -2;
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
