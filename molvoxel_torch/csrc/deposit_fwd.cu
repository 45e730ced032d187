// Forward deposit kernel for Hopper (sm_90a): atoms -> (B, C, Dl, H*W) grids.
//
// Replaces three TPU kernels of molvoxel_tpu/ops/pallas_deposit.py:
//   _kernel_v5        (whole-row tiles, every grid with H*W % 128 == 0),
//   _kernel_gaussian  (streamed fallback for gaussian, ragged H*W or 256^3),
//   _kernel_binary    (the same fallback for binary density).
// The TPU needed the two fallbacks only for its 128-lane block rule and its
// VMEM budget.  Here one block owns a flat run of voxels, masks the ragged
// end of the H*W plane, and bounds its tile by shared memory, not by the
// grid, so this one kernel computes what all three compute, for every grid.
//
// Function (per output voxel (b, d, h, w), per channel c):
//   dx = (d*res - hw) - x'   (x' pre-shifted by d_offset*res)
//   th = r2 - dx*dx;  dyz2 = (h*res - hw - y)^2 + (w*res - hw - z)^2
//   out += w[c] * exp(coef*dx^2) * exp(coef*dy^2) * exp(coef*dz^2)  if dyz2 <= th
//   (binary: out += w[c] if dyz2 <= th)
// The cutoff arithmetic uses __fsub_rn / __fmul_rn / __fadd_rn so that nvcc
// cannot contract it into FMAs: a voxel on the boundary must round exactly
// like the reference (a flipped compare costs exp(-0.5/sigma^2) ~ 0.135).
//
// Inputs, prepared in torch (molvoxel_torch/ops/deposit.py):
//   atoms   (B, 8, Vp) f32 rows [x', y, z, r2_thresh, coef, 0, 0, 0]
//   weights (B, C, Vp) f32, zero for padded / masked atoms
//   ranges  (B, nhwt, nvc, 2) i32 [d_lo, d_hi) per (hw tile, atom chunk)
// Output: (B, C, Dl, H*W) in f32, bf16 or fp8-e4m3; accumulation is f32 in
// registers and the cast happens once, at the store.
//
// Design: a block of 256 threads owns kTileHW = 128 consecutive flat h*w
// voxels times kTileD = 2 depth planes, and kCT channels (a grid axis covers
// more channels).  Each thread owns one voxel's kCT accumulators, so every
// output element has exactly one writer: no atomics.  The block walks the
// atom chunks of 64; it skips a chunk whose precomputed plane range misses
// its depth planes, then stages the chunk's rows in shared memory and keeps
// only the atoms whose cutoff sphere can reach the block's box (a
// conservative box-distance test, compacted in atom order with warp
// ballots so the summation order is fixed).  Shared memory is 64*(5+kCT)
// floats, well under the 48 KB static limit.
//
// What bounds it on an H100 SXM: the output write (B*C*Dl*H*W elements, at
// 3.35 TB/s) on ligand batches, and the FP32/SFU work of the (atom, voxel)
// pairs inside each block's reach (three expf and ~15 FP32 operations a
// pair, against 67 TFLOP/s) on proteins.  The chunk ranges and the per-block
// culling keep the pair work near the pairs that are really in reach; the
// stores are coalesced (consecutive threads, consecutive h*w).  Tensor cores,
// TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileHW = 128;
constexpr int kTileD = kThreads / kTileHW;
constexpr int kChunk = 64;
constexpr int kChunkWarps = kChunk / 32;

template <typename T>
__device__ __forceinline__ T cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <>
__device__ __forceinline__ __nv_fp8_storage_t cast_out<__nv_fp8_storage_t>(float v) {
  return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// Voxel-center position idx*res - half_width, rounded like the reference.
__device__ __forceinline__ float axis_pos(int idx, float res, float half_width) {
  return __fsub_rn(__fmul_rn(static_cast<float>(idx), res), half_width);
}

// Distance from v to the interval [lo, hi], 0 inside.
__device__ __forceinline__ float gap(float v, float lo, float hi) {
  return fmaxf(fmaxf(lo - v, v - hi), 0.0f);
}

template <bool kGaussian, int kCT, typename OutT>
__global__ void __launch_bounds__(kThreads)
deposit_fwd_kernel(const float* __restrict__ atoms, const float* __restrict__ weights,
                   const int* __restrict__ ranges, OutT* __restrict__ out, int vp, int channels,
                   int dl, int dim, int nct, float res, float half_width) {
  __shared__ float s_x[kChunk], s_y[kChunk], s_z[kChunk], s_r2[kChunk], s_coef[kChunk];
  __shared__ float s_w[kCT][kChunk];
  __shared__ int s_count[kChunkWarps];

  const int hw_total = dim * dim;
  const int nhwt = gridDim.x;
  const int nvc = vp / kChunk;
  const int tile = blockIdx.x;
  const int d0 = blockIdx.y * kTileD;
  const int b = blockIdx.z / nct;
  const int c0 = (blockIdx.z % nct) * kCT;

  const int t = threadIdx.x;
  const int hw = tile * kTileHW + (t % kTileHW);
  const int d = d0 + t / kTileHW;
  const bool live = hw < hw_total && d < dl;
  const int h = hw / dim;
  const float px = axis_pos(d, res, half_width);
  const float py = axis_pos(h, res, half_width);
  const float pz = axis_pos(hw - h * dim, res, half_width);

  // The block's box: its depth planes, its h rows, every w column.
  const int hw_first = tile * kTileHW;
  const int hw_last = min(hw_first + kTileHW, hw_total) - 1;
  const int d_last = min(d0 + kTileD, dl) - 1;
  const float bx_lo = axis_pos(d0, res, half_width), bx_hi = axis_pos(d_last, res, half_width);
  const float by_lo = axis_pos(hw_first / dim, res, half_width), by_hi = axis_pos(hw_last / dim, res, half_width);
  const float bz_lo = axis_pos(0, res, half_width), bz_hi = axis_pos(dim - 1, res, half_width);

  const float* a_row = atoms + static_cast<size_t>(b) * 8 * vp;
  const float* w_row = weights + static_cast<size_t>(b) * channels * vp;
  const int* r_row = ranges + (static_cast<size_t>(b) * nhwt + tile) * nvc * 2;

  float acc[kCT];
#pragma unroll
  for (int k = 0; k < kCT; ++k) acc[k] = 0.0f;

  for (int vc = 0; vc < nvc; ++vc) {
    const int lo = r_row[2 * vc], hi = r_row[2 * vc + 1];
    if (hi <= d0 || lo > d_last) continue;  // uniform across the block

    __syncthreads();  // the previous chunk's readers are done with shared memory
    bool keep = false;
    unsigned ballot = 0;
    float ax = 0.f, ay = 0.f, az = 0.f, ar2 = 0.f, acoef = 0.f;
    const int v = vc * kChunk + t;
    if (t < kChunk) {
      ax = a_row[v];
      ay = a_row[vp + v];
      az = a_row[2 * vp + v];
      ar2 = a_row[3 * vp + v];
      acoef = a_row[4 * vp + v];
      const float gx = gap(ax, bx_lo, bx_hi), gy = gap(ay, by_lo, by_hi), gz = gap(az, bz_lo, bz_hi);
      // conservative: rounding can only keep an atom that reaches nothing
      keep = gx * gx + gy * gy + gz * gz <= ar2 * 1.00001f + 1e-5f;
      ballot = __ballot_sync(0xffffffffu, keep);
      if ((t & 31) == 0) s_count[t >> 5] = __popc(ballot);
    }
    __syncthreads();
    int n = 0, offset = 0;
#pragma unroll
    for (int i = 0; i < kChunkWarps; ++i) {
      if (i < (t >> 5)) offset += s_count[i];
      n += s_count[i];
    }
    if (t < kChunk && keep) {
      const int pos = offset + __popc(ballot & ((1u << (t & 31)) - 1u));
      s_x[pos] = ax;
      s_y[pos] = ay;
      s_z[pos] = az;
      s_r2[pos] = ar2;
      s_coef[pos] = acoef;
#pragma unroll
      for (int k = 0; k < kCT; ++k) s_w[k][pos] = (c0 + k < channels) ? w_row[(c0 + k) * vp + v] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(px, s_x[j]);
      const float dx2 = __fmul_rn(dx, dx);
      const float th = __fsub_rn(s_r2[j], dx2);
      const float dy = __fsub_rn(py, s_y[j]);
      const float dz = __fsub_rn(pz, s_z[j]);
      const float dy2 = __fmul_rn(dy, dy);
      const float dz2 = __fmul_rn(dz, dz);
      const float dyz2 = __fadd_rn(dy2, dz2);
      if (dyz2 <= th) {
        if (kGaussian) {
          const float cf = s_coef[j];
          const float ex = expf(dx2 * cf);
          const float eyz = expf(dy2 * cf) * expf(dz2 * cf);
#pragma unroll
          for (int k = 0; k < kCT; ++k) acc[k] += (s_w[k][j] * ex) * eyz;
        } else {
#pragma unroll
          for (int k = 0; k < kCT; ++k) acc[k] += s_w[k][j];
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < kCT; ++k) {
    if (c0 + k < channels) {
      out[((static_cast<size_t>(b) * channels + c0 + k) * dl + d) * hw_total + hw] = cast_out<OutT>(acc[k]);
    }
  }
}

template <bool kGaussian, int kCT, typename OutT>
void launch(const float* atoms, const float* weights, const int* ranges, void* out, int batch, int vp,
            int channels, int dl, int dim, float res, float half_width, cudaStream_t stream) {
  const int nct = (channels + kCT - 1) / kCT;
  const int nhwt = (dim * dim + kTileHW - 1) / kTileHW;
  dim3 grid(nhwt, (dl + kTileD - 1) / kTileD, batch * nct);
  deposit_fwd_kernel<kGaussian, kCT, OutT><<<grid, kThreads, 0, stream>>>(
      atoms, weights, ranges, static_cast<OutT*>(out), vp, channels, dl, dim, nct, res, half_width);
}

template <bool kGaussian, typename OutT>
void launch_ct(const float* atoms, const float* weights, const int* ranges, void* out, int batch, int vp,
               int channels, int dl, int dim, float res, float half_width, cudaStream_t stream) {
  if (channels <= 1) {
    launch<kGaussian, 1, OutT>(atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, stream);
  } else if (channels <= 4) {
    launch<kGaussian, 4, OutT>(atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, stream);
  } else {
    launch<kGaussian, 8, OutT>(atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, stream);
  }
}

template <typename OutT>
void launch_density(int gaussian, const float* atoms, const float* weights, const int* ranges, void* out,
                    int batch, int vp, int channels, int dl, int dim, float res, float half_width,
                    cudaStream_t stream) {
  if (gaussian) {
    launch_ct<true, OutT>(atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, stream);
  } else {
    launch_ct<false, OutT>(atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, stream);
  }
}

}  // namespace

extern "C" {

// Tile constants, so the Python side computes ranges at the kernel's tiles.
int deposit_fwd_tile_hw() { return kTileHW; }
int deposit_fwd_chunk() { return kChunk; }

// out_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
int deposit_fwd(const void* atoms, const void* weights, const void* ranges, void* out, int batch, int vp,
                int channels, int dl, int dim, float res, float half_width, int gaussian, int out_kind,
                void* stream) {
  if (batch <= 0 || vp <= 0 || vp % kChunk != 0 || channels <= 0 || dl <= 0 || dim <= 0 || out_kind < 0 ||
      out_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nct = (channels + 7) / 8;
  if (static_cast<long long>(batch) * nct > 65535 || (dl + kTileD - 1) / kTileD > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const float* a = static_cast<const float*>(atoms);
  const float* w = static_cast<const float*>(weights);
  const int* r = static_cast<const int*>(ranges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0) {
    launch_density<float>(gaussian, a, w, r, out, batch, vp, channels, dl, dim, res, half_width, s);
  } else if (out_kind == 1) {
    launch_density<__nv_bfloat16>(gaussian, a, w, r, out, batch, vp, channels, dl, dim, res, half_width, s);
  } else {
    launch_density<__nv_fp8_storage_t>(gaussian, a, w, r, out, batch, vp, channels, dl, dim, res, half_width, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
