// Backward deposit kernel for Hopper (sm_90a): cotangent grid -> per-atom gradients.
//
// Replaces _kernel_v5_bwd of molvoxel_tpu/ops/pallas_deposit.py (launched by
// voxelize_pallas_bwd_batch).  It computes the VJP of deposit_fwd.cu for the
// same inputs: for each atom, with f = exp(coef * d^2) inside the cutoff
// (binary: f = 1) and Q = sum_c ct[c] * w[c] at each voxel,
//   grad_w[c]     = sum_vox ct[c] * f
//   grad_rows[0:3] = 2 coef * sum_vox Q f (x - g)      (dL/dx, dL/dy, dL/dz)
//   grad_rows[4]   = sum_vox Q f d^2                    (dL/dcoef)
// and zeros in rows 3 and 5-7 (the cutoff's boundary term is dropped: the
// almost-everywhere gradient).  Binary density writes grad_w only.
//
// Inputs (molvoxel_torch/ops/deposit.py):
//   atoms   (B, 8, Vp) f32 rows [x', y, z, r2_thresh, coef, 0, 0, 0]
//   weights (B, C, Vp) f32
//   ct      (B, C, Dl, H*W) f32, or bf16 (the low-precision lane)
// Outputs: grad_rows (B, 8, Vp) f32, grad_w (B, C, Vp) f32, every element
// written exactly once.
//
// Design: atom-centric.  The TPU kernel puts one program on each (atom
// chunk, hw tile) and accumulates resident output blocks across hw tiles;
// Hopper blocks carry nothing from one to the next, and gradients take no
// atomics.  So one warp owns one (molecule, atom): its lanes stride over the
// voxels of the atom's cutoff box (built from sqrt(r2_thresh) with slack,
// clipped to the grid or slab), apply the forward's exact predicate, and
// accumulate in f32 registers; a fixed xor-shuffle tree reduces the warp and
// lane 0 writes.  The result is deterministic, and needs no shared memory,
// no plane ranges and no Morton order.  Channels beyond kCT run on a grid
// axis; the coordinate terms (which need Q over every channel) come from the
// first channel group only.  (x - g) is taken per voxel: no moment sums about
// the grid origin, which cancel badly in f32.
//
// The cutoff arithmetic is deposit_fwd.cu's, __fsub_rn / __fmul_rn /
// __fadd_rn in the same order, so a boundary voxel is in or out exactly as
// it was in the forward.
//
// What bounds it on an H100 SXM: the FP32/SFU work of the in-cutoff (atom,
// voxel) pairs (three expf and ~10 + 4C FP32 operations a pair) and the
// cotangent voxels the atoms reach (read once at 3.35 TB/s).  Lanes walk the
// box with the w index fastest, so a warp's cotangent reads fall on short
// contiguous runs.  Shared-memory staging of the cotangent and tensor cores
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Voxel-center position idx*res - half_width, rounded like the forward.
__device__ __forceinline__ float axis_pos(int idx, float res, float half_width) {
  return __fsub_rn(__fmul_rn(static_cast<float>(idx), res), half_width);
}

// Indices i in [0, n) whose voxel center can lie within `reach` of p,
// widened by one on each side; empty when hi < lo.  Clamped in float first,
// so far-off padding atoms and huge inputs convert safely.
__device__ __forceinline__ void axis_range(float p, float reach, float res, float half_width, int n, int& lo,
                                           int& hi) {
  const float flo = floorf((p - reach + half_width) / res) - 1.0f;
  const float fhi = floorf((p + reach + half_width) / res) + 1.0f;
  lo = static_cast<int>(fminf(fmaxf(flo, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fmaxf(fminf(fhi, static_cast<float>(n - 1)), -1.0f));
}

__device__ __forceinline__ float load_ct(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ct(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <bool kGaussian, int kCT, typename CtT>
__global__ void __launch_bounds__(kThreads)
deposit_bwd_kernel(const float* __restrict__ atoms, const float* __restrict__ weights, const CtT* __restrict__ ct,
                   float* __restrict__ grad_rows, float* __restrict__ grad_w, int vp, int channels, int dl, int dim,
                   int nct, float res, float half_width) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y / nct;
  const int c0 = (blockIdx.y % nct) * kCT;
  if (v >= vp) return;  // uniform across the warp

  const float* a_row = atoms + static_cast<size_t>(b) * 8 * vp;
  const float x = a_row[v], y = a_row[vp + v], z = a_row[2 * vp + v];
  const float th = a_row[3 * vp + v], cf = a_row[4 * vp + v];
  const float* w_row = weights + static_cast<size_t>(b) * channels * vp;
  float wk[kCT];
#pragma unroll
  for (int k = 0; k < kCT; ++k) wk[k] = (c0 + k < channels) ? w_row[static_cast<size_t>(c0 + k) * vp + v] : 0.0f;
  const bool coord_terms = kGaussian && c0 == 0;

  // the atom's cutoff box; the exact predicate below decides
  const float reach = sqrtf(fmaxf(th, 0.0f)) * 1.0001f + 1e-4f;
  int dlo, dhi, hlo, hhi, wlo, whi;
  axis_range(x, reach, res, half_width, dl, dlo, dhi);
  axis_range(y, reach, res, half_width, dim, hlo, hhi);
  axis_range(z, reach, res, half_width, dim, wlo, whi);
  const int nd = dhi - dlo + 1, nh = hhi - hlo + 1, nw = whi - wlo + 1;
  const int nhw = nh * nw;
  const int n = (nd > 0 && nh > 0 && nw > 0) ? nd * nhw : 0;

  const size_t hw_total = static_cast<size_t>(dim) * dim;
  const size_t c_stride = static_cast<size_t>(dl) * hw_total;
  const CtT* ct_b = ct + static_cast<size_t>(b) * channels * c_stride;

  float gw[kCT];
#pragma unroll
  for (int k = 0; k < kCT; ++k) gw[k] = 0.0f;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sd = 0.0f;

  for (int idx = lane; idx < n; idx += 32) {
    const int i = dlo + idx / nhw;
    const int rem = idx - (i - dlo) * nhw;
    const int h = hlo + rem / nw;
    const int wc = wlo + rem - (h - hlo) * nw;
    const float dx = __fsub_rn(axis_pos(i, res, half_width), x);
    const float dx2 = __fmul_rn(dx, dx);
    const float t_th = __fsub_rn(th, dx2);
    const float dy = __fsub_rn(axis_pos(h, res, half_width), y);
    const float dz = __fsub_rn(axis_pos(wc, res, half_width), z);
    const float dy2 = __fmul_rn(dy, dy);
    const float dz2 = __fmul_rn(dz, dz);
    const float dyz2 = __fadd_rn(dy2, dz2);
    if (!(dyz2 <= t_th)) continue;
    const CtT* g_vox = ct_b + static_cast<size_t>(i) * hw_total + static_cast<size_t>(h) * dim + wc;
    if (kGaussian) {
      const float f = expf(dx2 * cf) * (expf(dy2 * cf) * expf(dz2 * cf));
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < kCT; ++k) {
        if (c0 + k < channels) {
          const float g = load_ct(g_vox + (c0 + k) * c_stride);
          gw[k] += g * f;
          q += g * wk[k];
        }
      }
      if (coord_terms) {
        for (int c = kCT; c < channels; ++c) q += load_ct(g_vox + c * c_stride) * w_row[static_cast<size_t>(c) * vp + v];
        const float t = q * f;
        sx -= t * dx;
        sy -= t * dy;
        sz -= t * dz;
        sd += t * (dx2 + dyz2);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCT; ++k) {
        if (c0 + k < channels) gw[k] += load_ct(g_vox + (c0 + k) * c_stride);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kCT; ++k) gw[k] = warp_sum(gw[k]);
  if (coord_terms) {
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    sz = warp_sum(sz);
    sd = warp_sum(sd);
  }
  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < kCT; ++k) {
    if (c0 + k < channels) grad_w[(static_cast<size_t>(b) * channels + c0 + k) * vp + v] = gw[k];
  }
  if (c0 == 0) {
    float* gr = grad_rows + static_cast<size_t>(b) * 8 * vp + v;
    const float two_cf = 2.0f * cf;
    gr[0] = coord_terms ? two_cf * sx : 0.0f;
    gr[vp] = coord_terms ? two_cf * sy : 0.0f;
    gr[2 * vp] = coord_terms ? two_cf * sz : 0.0f;
    gr[3 * vp] = 0.0f;
    gr[4 * vp] = coord_terms ? sd : 0.0f;
    gr[5 * vp] = 0.0f;
    gr[6 * vp] = 0.0f;
    gr[7 * vp] = 0.0f;
  }
}

template <bool kGaussian, int kCT, typename CtT>
void launch(const float* atoms, const float* weights, const void* ct, float* grad_rows, float* grad_w, int batch,
            int vp, int channels, int dl, int dim, float res, float half_width, cudaStream_t stream) {
  const int nct = (channels + kCT - 1) / kCT;
  dim3 grid((vp + kWarps - 1) / kWarps, batch * nct);
  deposit_bwd_kernel<kGaussian, kCT, CtT><<<grid, kThreads, 0, stream>>>(
      atoms, weights, static_cast<const CtT*>(ct), grad_rows, grad_w, vp, channels, dl, dim, nct, res, half_width);
}

template <bool kGaussian, typename CtT>
void launch_ct(const float* atoms, const float* weights, const void* ct, float* grad_rows, float* grad_w, int batch,
               int vp, int channels, int dl, int dim, float res, float half_width, cudaStream_t stream) {
  if (channels <= 1) {
    launch<kGaussian, 1, CtT>(atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                              stream);
  } else if (channels <= 4) {
    launch<kGaussian, 4, CtT>(atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                              stream);
  } else {
    launch<kGaussian, 8, CtT>(atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                              stream);
  }
}

template <typename CtT>
void launch_density(int gaussian, const float* atoms, const float* weights, const void* ct, float* grad_rows,
                    float* grad_w, int batch, int vp, int channels, int dl, int dim, float res, float half_width,
                    cudaStream_t stream) {
  if (gaussian) {
    launch_ct<true, CtT>(atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width, stream);
  } else {
    launch_ct<false, CtT>(atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                          stream);
  }
}

}  // namespace

extern "C" {

// ct_kind: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); nothing is synchronised.
int deposit_bwd(const void* atoms, const void* weights, const void* ct, void* grad_rows, void* grad_w, int batch,
                int vp, int channels, int dl, int dim, float res, float half_width, int gaussian, int ct_kind,
                void* stream) {
  if (batch <= 0 || vp <= 0 || channels <= 0 || dl <= 0 || dim <= 0 || ct_kind < 0 || ct_kind > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nct = channels <= 4 ? 1 : (channels + 7) / 8;
  if (static_cast<long long>(batch) * nct > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const float* a = static_cast<const float*>(atoms);
  const float* w = static_cast<const float*>(weights);
  float* gr = static_cast<float*>(grad_rows);
  float* gw = static_cast<float*>(grad_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_kind == 0) {
    launch_density<float>(gaussian, a, w, ct, gr, gw, batch, vp, channels, dl, dim, res, half_width, s);
  } else {
    launch_density<__nv_bfloat16>(gaussian, a, w, ct, gr, gw, batch, vp, channels, dl, dim, res, half_width, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
