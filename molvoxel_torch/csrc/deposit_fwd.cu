// Forward deposit kernel for Hopper (sm_90a): atoms -> (B, C, Dl, H*W) grids.
//
// Replaces three TPU kernels of molvoxel_tpu/ops/pallas_deposit.py:
//   _kernel_v5        (whole-row tiles, every grid with H*W % 128 == 0),
//   _kernel_gaussian  (streamed fallback for gaussian, ragged H*W or 256^3),
//   _kernel_binary    (the same fallback for binary density).
// The TPU needed the two fallbacks only for its 128-lane block rule and its
// VMEM budget.  Here a block owns a brick of whole rows and masks the ragged
// edges itself, so this one kernel computes what all three compute, for
// every grid.
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
//   ranges  (B, nht, nvc, 2) i32 [d_lo, d_hi) per (tile of ht h rows, atom chunk):
//           ht the brick's rows, or a tile launch's range rows
// Output: (B, C, Dl, H*W) in f32, bf16 or fp8-e4m3; accumulation is f32 in
// registers and the cast happens once, at the store.
//
// What bounds it on an H100 SXM.  The bytes: the grid written once, at
// 3.35 TB/s, against a few FP32 operations for each in-cutoff pair (67
// TFLOP/s).  What kept the first version far from that bound was its block
// count: 256-voxel blocks, 65,536 of them on the 64^3 x 4 batch, each a
// serial chain (load the chunk range, then the atoms, three barriers, the
// pair loop, a 2-byte store a thread), about 62 waves of that chain.  On a
// protein the chain of the busiest block (its walk over the atom chunks)
// sets the time, not the bytes.
//
// Design.
// - Bricks: a block owns dt depth planes x ht whole h rows x all W columns
//   of kCT channels of one molecule.  The wrapper picks (dt, ht, threads,
//   passes) per grid: bricks as large as the accumulators allow on ligand
//   batches (a few thousand blocks), smaller on proteins, where more blocks
//   shorten the busiest block's walk.  The work item (molecule, channel
//   group, depth tile, row tile) is blockIdx.x, so no grid axis caps B *
//   channel groups.  A thread owns a run of R consecutive w (16 bytes of
//   output: 4 f32, 8 bf16, 16 fp8) in one row, on each of its passes over
//   the brick, and at most kAccMax accumulators, so that 3 blocks of 256
//   threads share an SM.
// - No dependent load chains: the block reads its whole (nvc, 2) range row
//   at once, compacts the active chunks with ballots, and stages their atom
//   rows and weights in a four-slot shared-memory ring with cp.async, so
//   chunks k+1..k+3 arrive while chunk k is used.  A brick no chunk reaches
//   stores its zeros without any atom load.
// - Culling: chunk ranges, then a conservative box test per atom against
//   the brick, which also drops atoms with no weight in the block's
//   channels (masked atoms, other channels' virtual atoms), compacted in
//   atom order (warp ballots), so the summation order is fixed and two
//   launches give bit-identical grids.  Per thread, an atom skips the run
//   when the run's row lies outside the atom's rows or dy^2 exceeds th.
// - Separable factor tables: for up to kGroup kept atoms at a time,
//   ex[d], ey[h] and ez[w] = exp(coef * axis distance^2) are filled once per
//   brick in shared memory (the same expf on the same __fmul_rn squares),
//   so a pair costs the exact cutoff compare and C FMAs, no expf.  ey and
//   ez cover only the rows and columns within the atom's reach (plus a
//   voxel of margin): a table over all W columns cost more than the pairs
//   it served, since an atom reaches a few columns of a 48- to 256-wide row.
// - Stores: each run is written as one 16-byte store where W * element size
//   is a multiple of 16; otherwise (dims 20 and 33, for example) by element.
// - One writer per output element, no atomics, no TF32 (no tensor cores).
//
// Molecules of more than one chunk (proteins, complexes), gaussian or
// binary, at the exact cutoff or on threshold rows (gaussian_notrunc:
// r2_thresh = r^2 * notrunc_factor, a reach of about 3.2 r), take a second
// kernel, deposit_fwd_tile_kernel.  A brick of whole rows keeps every atom
// whose sphere reaches its slab anywhere across the row: a protein's blocks
// walk 8-24 chunks each, three barriers a chunk, and every thread tests
// every kept atom on each of its passes, for compares that mostly miss (an
// atom of radius 1 A reaches 5 of a brick's 64 rows).  So:
// - Sub-bricks: a warp owns 4 planes x 4 rows x 16 columns (32 for fp8),
//   or twice the columns with wide lanes; lane (dd, hh, half) owns one
//   row's 8 (16 fp8) consecutive w, or twice that, in 16-byte stores.  A
//   block is bd x bh x bw such warps; the wrapper picks the lanes' width
//   and the block from the shapes and the reach (``tile_brick``): wide
//   lanes spread a tile's walk over more voxels.
// - Culling twice, in 3-D.  The block's warps take the active chunks (the
//   plane ranges of every range row the tile meets, a ballot mask each warp
//   builds for itself; the wrapper writes the ranges at the tiles' own rows)
//   one a warp a round, load their 64 atoms straight from global memory and
//   keep those whose sphere reaches the block's box; one barrier a round
//   puts them in a shared list in chunk, then atom order.  Each warp then
//   keeps, from that list and in its order, the atoms that reach its own
//   sub-brick, 32 at a time.  A tile no chunk reaches stores its zeros
//   without loading an atom.
// - Tables a warp (gaussian): ex[4], ey[4] and ez over the sub-brick's
//   columns for each kept atom (the same expf of the same squares as the brick
//   kernel), so a lane's atom costs the exact cutoff compares and one FMA a
//   voxel; binary adds the weight and needs none.
// - The same arithmetic and order as the brick kernel (the exact cutoff,
//   m = ex * ey, w * m, one FMA with ez, or the weight alone; chunk then
//   atom order), so each voxel gets the brick kernel's bits; f32 sums, one
//   cast at the store.
// Single-chunk molecules (ligand batches) keep the brick kernel, whose slab
// test already sees only that chunk.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;        // atoms per chunk; the plane ranges are per chunk
constexpr int kGroup = 32;        // kept atoms per fill of the factor tables
constexpr int kMaxThreads = 256;  // threads of the largest block
constexpr int kAccMax = 32;       // f32 accumulators a thread holds: passes * R * kCT
constexpr int kStoreBytes = 16;   // bytes a thread stores at once
constexpr int kRows = 5;          // atom rows read: x', y, z, r2_thresh, coef
constexpr int kStages = 4;        // chunks the cp.async ring holds: up to 3 in flight while one is used

struct Args {
  const float* atoms;
  const float* weights;
  const int* ranges;
  void* out;
  int vp, channels, dl, dim;
  int nct, dt, ht, ndt, nht, nrun, passes;
  float res, half_width;
};

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

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_fp8_storage_t v) { return v; }

// Cast R = 16 / sizeof(OutT) values and write them with one 16-byte store.
template <typename OutT, int R>
__device__ __forceinline__ void store_run(OutT* p, const float (&v)[R]) {
  static_assert(R * sizeof(OutT) == kStoreBytes, "a run is 16 bytes");
  constexpr int kPer = 4 / sizeof(OutT);  // values per 32-bit word
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < R; ++i) word[i / kPer] |= bits_of(cast_out<OutT>(v[i])) << (8 * sizeof(OutT) * (i % kPer));
  *reinterpret_cast<uint4*>(p) = make_uint4(word[0], word[1], word[2], word[3]);
}

// Voxel-center position idx*res - half_width, rounded like the reference.
__device__ __forceinline__ float axis_pos(int idx, float res, float half_width) {
  return __fsub_rn(__fmul_rn(static_cast<float>(idx), res), half_width);
}

// Distance from v to the interval [lo, hi], 0 inside.
__device__ __forceinline__ float gap(float v, float lo, float hi) {
  return fmaxf(fmaxf(lo - v, v - hi), 0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage chunk vc: kRows atom rows, then kCT weight rows (zero beyond C);
// the caller commits the group.
template <int kCT>
__device__ __forceinline__ void stage_chunk(float* dst, const float* a_row, const float* w_row, const Args& a,
                                            int c0, int vc) {
  constexpr int kQuads = kChunk / 4;
  for (int s = threadIdx.x; s < (kRows + kCT) * kQuads; s += blockDim.x) {
    const int col = s / kQuads, q = s - col * kQuads;
    const size_t off = static_cast<size_t>(vc) * kChunk + q * 4;
    const float* src = a_row;
    bool valid = true;
    if (col < kRows) {
      src = a_row + static_cast<size_t>(col) * a.vp + off;
    } else {
      const int c = c0 + col - kRows;
      valid = c < a.channels;
      if (valid) src = w_row + static_cast<size_t>(c) * a.vp + off;
    }
    cp_async16(dst + col * kChunk + q * 4, src, valid);
  }
}

template <bool kGaussian, int kCT, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 3) deposit_fwd_kernel(const Args a) {
  constexpr int R = kStoreBytes / sizeof(OutT);
  constexpr int kPass = kAccMax / (R * kCT);
  constexpr int kCols = kRows + kCT;
  static_assert(kPass >= 1, "accumulators exceed the budget");

  extern __shared__ __align__(16) float smem[];
  float* s_raw = smem;                               // [kStages][kCols][kChunk], the cp.async ring
  float* s_keep = s_raw + kStages * kCols * kChunk;  // [kCols][kChunk], kept atoms in atom order
  float* s_tab = s_keep + kCols * kChunk;      // [kGroup][dt + kh + kw] factor tables, kh <= ht, kw <= dim
  __shared__ int s_list[kMaxThreads];
  __shared__ int s_count[kMaxThreads / 32];
  __shared__ int2 s_rows[kChunk];              // first and last brick row of each kept atom's window
  __shared__ int s_wl[kChunk];                 // first column of each kept atom's window
  __shared__ int s_nkeep, s_kh, s_kw;           // kept atoms; rows and columns of the widest window

  int item = blockIdx.x;
  const int ti = item % a.nht;
  item /= a.nht;
  const int di = item % a.ndt;
  item /= a.ndt;
  const int c0 = (item % a.nct) * kCT;
  const int b = item / a.nct;
  const int d0 = di * a.dt, h0 = ti * a.ht;
  const int d_last = min(d0 + a.dt, a.dl) - 1, h_last = min(h0 + a.ht, a.dim) - 1;
  const int units = a.dt * a.ht * a.nrun;
  const float res = a.res, hw = a.half_width;

  // The brick's box: its depth planes, its h rows, every w column.
  const float bx_lo = axis_pos(d0, res, hw), bx_hi = axis_pos(d_last, res, hw);
  const float by_lo = axis_pos(h0, res, hw), by_hi = axis_pos(h_last, res, hw);
  const float bz_lo = axis_pos(0, res, hw), bz_hi = axis_pos(a.dim - 1, res, hw);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int nvc = a.vp / kChunk;
  const int2* r_row = reinterpret_cast<const int2*>(a.ranges) + (static_cast<size_t>(b) * a.nht + ti) * nvc;
  const float* a_row = a.atoms + static_cast<size_t>(b) * 8 * a.vp;
  const float* w_row = a.weights + static_cast<size_t>(b) * a.channels * a.vp;

  float acc[kPass][R][kCT];
#pragma unroll
  for (int p = 0; p < kPass; ++p)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < kCT; ++k) acc[p][i][k] = 0.0f;

  for (int base = 0; base < nvc; base += blockDim.x) {
    // the active chunks of this segment of the range row, in chunk order
    const int vc = base + t;
    bool act = false;
    if (vc < nvc) {
      const int2 r = r_row[vc];
      act = r.y > d0 && r.x <= d_last;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int n_act = 0, pos = 0;
    for (int i = 0; i < nwarps; ++i) {
      if (i < warp) pos += s_count[i];
      n_act += s_count[i];
    }
    if (act) s_list[pos + __popc(bal & ((1u << lane) - 1u))] = vc;
    __syncthreads();
    if (n_act == 0) continue;  // uniform across the block

    // one cp.async group per chunk, empty past the list, so that group n is chunk n
    for (int n = 0; n < kStages - 1; ++n) {
      if (n < n_act) stage_chunk<kCT>(s_raw + n * kCols * kChunk, a_row, w_row, a, c0, s_list[n]);
      cp_async_commit();
    }
    for (int n = 0; n < n_act; ++n) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk n has landed; the previous chunk's readers are done
      // the slot of chunk n-1, whose box test ended before this barrier, takes chunk n + kStages - 1
      const int ahead = n + kStages - 1;
      if (ahead < n_act) {
        stage_chunk<kCT>(s_raw + (ahead % kStages) * kCols * kChunk, a_row, w_row, a, c0, s_list[ahead]);
      }
      cp_async_commit();

      if (warp == 0) {  // box test and compaction of the chunk's 64 atoms, in atom order
        const float* raw = s_raw + (n % kStages) * kCols * kChunk;
        bool keep[2];
        unsigned kb[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          const float gx = gap(raw[j], bx_lo, bx_hi), gy = gap(raw[kChunk + j], by_lo, by_hi);
          const float gz = gap(raw[2 * kChunk + j], bz_lo, bz_hi);
          // conservative: rounding can only keep an atom that reaches nothing
          keep[half] = gx * gx + gy * gy + gz * gz <= raw[3 * kChunk + j] * 1.00001f + 1e-5f;
          // an atom with no weight in these channels (masked, or another channel's
          // virtual atom) adds nothing
          bool weighted = false;
#pragma unroll
          for (int k = 0; k < kCT; ++k) weighted |= raw[(kRows + k) * kChunk + j] != 0.0f;
          keep[half] = keep[half] && weighted;
          kb[half] = __ballot_sync(0xffffffffu, keep[half]);
        }
        const int n0 = __popc(kb[0]);
        unsigned kh = 0, kw = 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (keep[half]) {
            const int j = lane + 32 * half;
            const int at = (half ? n0 : 0) + __popc(kb[half] & ((1u << lane) - 1u));
#pragma unroll
            for (int col = 0; col < kCols; ++col) s_keep[col * kChunk + at] = raw[col * kChunk + j];
            // the rows of the brick and the columns the atom can reach, a voxel of margin each side
            const float reach = sqrtf(raw[3 * kChunk + j]), y = raw[kChunk + j], z = raw[2 * kChunk + j];
            const int hl = max(static_cast<int>(floorf((y - reach + hw) / res)) - 1, h0);
            const int hr = min(static_cast<int>(ceilf((y + reach + hw) / res)) + 1, h_last);
            const int wl = max(static_cast<int>(floorf((z - reach + hw) / res)) - 1, 0);
            const int wr = min(static_cast<int>(ceilf((z + reach + hw) / res)) + 1, a.dim - 1);
            s_rows[at] = make_int2(hl, hr);
            s_wl[at] = wl;
            kh = max(kh, static_cast<unsigned>(max(hr - hl + 1, 0)));
            kw = max(kw, static_cast<unsigned>(max(wr - wl + 1, 0)));
          }
        }
        kh = __reduce_max_sync(0xffffffffu, kh);
        kw = __reduce_max_sync(0xffffffffu, kw);
        if (lane == 0) {
          s_nkeep = n0 + __popc(kb[1]);
          s_kh = static_cast<int>(kh);
          s_kw = static_cast<int>(kw);
        }
      }
      __syncthreads();
      const int nk = s_nkeep, kh = s_kh, kw = s_kw;
      const int per = a.dt + kh + kw;  // table entries of one atom: ex[dt], ey[kh], ez[kw]

      for (int g0 = 0; g0 < nk; g0 += kGroup) {
        const int ng = min(kGroup, nk - g0);
        if (kGaussian) {
          if (g0 > 0) __syncthreads();  // the previous group's readers are done with the tables
          for (int e = t; e < ng * per; e += blockDim.x) {
            const int j = g0 + e / per;
            const int k = e - (j - g0) * per;
            int idx, row;  // axis index and atom row (x', y or z) of this table entry
            if (k < a.dt) {
              idx = d0 + k, row = 0;
            } else if (k < a.dt + kh) {
              idx = s_rows[j].x + k - a.dt, row = 1;
            } else {
              idx = s_wl[j] + k - a.dt - kh, row = 2;
            }
            const float dd = __fsub_rn(axis_pos(idx, res, hw), s_keep[row * kChunk + j]);
            const float d2 = __fmul_rn(dd, dd);
            // a factor beyond r2_thresh on its own axis is never used: the cutoff rejects it
            s_tab[e] = d2 <= s_keep[3 * kChunk + j] ? expf(d2 * s_keep[4 * kChunk + j]) : 0.0f;
          }
          __syncthreads();
        }

#pragma unroll
        for (int p = 0; p < kPass; ++p) {
          if (p >= a.passes) break;
          const int u = t + p * blockDim.x;
          if (u >= units) continue;
          const int row = u / a.nrun, w0 = (u - row * a.nrun) * R;
          const int dd = row / a.ht, hh = row - dd * a.ht;
          const int d = d0 + dd, h = h0 + hh;
          if (d >= a.dl || h >= a.dim) continue;
          const float px = axis_pos(d, res, hw), py = axis_pos(h, res, hw);
          float pz[R];
#pragma unroll
          for (int i = 0; i < R; ++i) pz[i] = axis_pos(w0 + i, res, hw);
          for (int j = g0; j < g0 + ng; ++j) {
            const int2 rows = s_rows[j];
            if (h < rows.x || h > rows.y) continue;  // a row the atom cannot reach
            const float dx = __fsub_rn(px, s_keep[j]);
            const float dx2 = __fmul_rn(dx, dx);
            const float th = __fsub_rn(s_keep[3 * kChunk + j], dx2);
            const float dy = __fsub_rn(py, s_keep[kChunk + j]);
            const float dy2 = __fmul_rn(dy, dy);
            if (dy2 > th) continue;  // dyz2 >= dy2: the atom misses the whole run
            const float z = s_keep[2 * kChunk + j];
            const float* tab = s_tab + (j - g0) * per;  // ex[dd], then ey from row rows.x
            const float* ez = tab + a.dt + kh - s_wl[j];  // ez[w] for the columns of the window
            float mk[kCT];
            if (kGaussian) {
              const float m = tab[dd] * tab[a.dt + h - rows.x];
#pragma unroll
              for (int k = 0; k < kCT; ++k) mk[k] = s_keep[(kRows + k) * kChunk + j] * m;
            } else {
#pragma unroll
              for (int k = 0; k < kCT; ++k) mk[k] = s_keep[(kRows + k) * kChunk + j];
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float dz = __fsub_rn(pz[i], z);
              const float dyz2 = __fadd_rn(dy2, __fmul_rn(dz, dz));
              if (dyz2 <= th) {
                const float e = kGaussian ? ez[w0 + i] : 0.0f;  // inside the cutoff, inside the window
#pragma unroll
                for (int k = 0; k < kCT; ++k) {
                  if (kGaussian) {
                    acc[p][i][k] = fmaf(mk[k], e, acc[p][i][k]);
                  } else {
                    acc[p][i][k] += mk[k];
                  }
                }
              }
            }
          }
        }
      }
    }
  }

  OutT* out = static_cast<OutT*>(a.out);
  const size_t plane = static_cast<size_t>(a.dim) * a.dim;
  const bool vec = (a.dim * sizeof(OutT)) % kStoreBytes == 0;  // every row starts 16-byte aligned
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    if (p >= a.passes) break;
    const int u = t + p * blockDim.x;
    if (u >= units) continue;
    const int row = u / a.nrun, w0 = (u - row * a.nrun) * R;
    const int dd = row / a.ht, hh = row - dd * a.ht;
    const int d = d0 + dd, h = h0 + hh;
    if (d >= a.dl || h >= a.dim) continue;
#pragma unroll
    for (int k = 0; k < kCT; ++k) {
      if (c0 + k >= a.channels) continue;
      OutT* dst = out + ((static_cast<size_t>(b) * a.channels + c0 + k) * a.dl + d) * plane +
                  static_cast<size_t>(h) * a.dim + w0;
      float v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = acc[p][i][k];
      if (vec && w0 + R <= a.dim) {
        store_run<OutT, R>(dst, v);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (w0 + i < a.dim) dst[i] = cast_out<OutT>(v[i]);
      }
    }
  }
}

constexpr int kTileSide = 4;      // planes and rows of a warp's sub-brick
constexpr int kTileWarpCap = 32;  // atoms a warp deposits per fill of its factor tables

struct TileArgs {
  const float* atoms;
  const float* weights;
  const int* ranges;
  void* out;
  int vp, channels, dl, dim;
  int nct, bd, bh, bw;  // channel groups; warps of a block along d, h and w
  int ndt, nht, nwt;    // tiles along d, h and w
  int hr, nhr;          // rows of a plane-range row, and range rows
  float res, half_width;
};

// Inclusive prefix sum of v over the lanes, and the warp's total.
__device__ __forceinline__ int warp_scan_incl(int v, int lane, int& total) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  total = __shfl_sync(0xffffffffu, v, 31);
  return v;
}

// Whether an atom at (x, y, z) with r2_thresh r2 can reach the box
// [lo, hi]; conservative: rounding can only keep an atom that reaches nothing.
__device__ __forceinline__ bool reaches(float x, float y, float z, float r2, float3 lo, float3 hi) {
  const float gx = gap(x, lo.x, hi.x), gy = gap(y, lo.y, hi.y), gz = gap(z, lo.z, hi.z);
  return gx * gx + gy * gy + gz * gz <= r2 * 1.00001f + 1e-5f;
}

// Consecutive w a narrow tile lane owns: 8 (two 16-byte runs of f32, one of
// bf16) or 16 fp8 (one run); a wide lane owns twice as many.
template <typename OutT>
__host__ __device__ constexpr int tile_lane_w() {
  return sizeof(OutT) == 1 ? 16 : 8;
}

template <bool kGaussian, int kCT, int kLW, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 3) deposit_fwd_tile_kernel(const TileArgs a) {
  // kLW: consecutive w a lane owns, in runs of 16 bytes; a narrow lane keeps
  // their positions in registers, a wide one computes them where used (the
  // same rounding)
  constexpr bool kWide = kLW > tile_lane_w<OutT>();
  constexpr int kCols = kRows + kCT;
  constexpr int kPer = 2 * kTileSide + 2 * kLW;    // table entries of an atom: ex[4], ey[4], ez[2 kLW]
  static_assert(kLW * kCT <= kAccMax, "accumulators exceed the budget");

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int cap = nwarps * kChunk;  // atoms the block's kept list holds: a chunk a warp, one round
  extern __shared__ __align__(16) float smem[];
  float4* s_wat = reinterpret_cast<float4*>(smem);         // [warps][kTileWarpCap] x, y, z, r2
  float* s_tab = smem + 4 * nwarps * kTileWarpCap;         // [warps][kTileWarpCap][kPer] factor tables
  float* s_wcf = s_tab + nwarps * kTileWarpCap * kPer;     // [warps][kTileWarpCap] coef
  float* s_ww = s_wcf + nwarps * kTileWarpCap;             // [warps][kTileWarpCap][kCT] weights
  float* s_blk = s_ww + nwarps * kTileWarpCap * kCT;       // [kCols][cap] the block's kept atoms
  __shared__ int s_cnt[2][kMaxThreads / 32];
  int item = blockIdx.x;
  const int wi = item % a.nwt;
  item /= a.nwt;
  const int ti = item % a.nht;
  item /= a.nht;
  const int di = item % a.ndt;
  item /= a.ndt;
  const int c0 = (item % a.nct) * kCT;
  const int b = item / a.nct;
  const float res = a.res, hw = a.half_width;

  // the block's tile and this warp's sub-brick of 4 planes x 4 rows x 2 kLW columns
  const int d0 = di * kTileSide * a.bd, h0 = ti * kTileSide * a.bh, w0 = wi * 2 * kLW * a.bw;
  const int d_last = min(d0 + kTileSide * a.bd, a.dl) - 1, h_last = min(h0 + kTileSide * a.bh, a.dim) - 1;
  const int w_last = min(w0 + 2 * kLW * a.bw, a.dim) - 1;
  const int wd = warp / (a.bh * a.bw), wh = (warp / a.bw) % a.bh, ww = warp % a.bw;
  const int sd0 = d0 + kTileSide * wd, sh0 = h0 + kTileSide * wh, sw0 = w0 + 2 * kLW * ww;
  const bool warp_live = sd0 < a.dl && sh0 < a.dim && sw0 < a.dim;
  const float3 blo = make_float3(axis_pos(d0, res, hw), axis_pos(h0, res, hw), axis_pos(w0, res, hw));
  const float3 bhi = make_float3(axis_pos(d_last, res, hw), axis_pos(h_last, res, hw), axis_pos(w_last, res, hw));
  const float3 wlo = make_float3(axis_pos(sd0, res, hw), axis_pos(sh0, res, hw), axis_pos(sw0, res, hw));
  const float3 whi = make_float3(axis_pos(min(sd0 + kTileSide, a.dl) - 1, res, hw),
                                 axis_pos(min(sh0 + kTileSide, a.dim) - 1, res, hw),
                                 axis_pos(min(sw0 + 2 * kLW, a.dim) - 1, res, hw));

  // this lane's voxels: plane sd0 + dd, row sh0 + hh, columns wl .. wl + kLW - 1
  const int dd = lane >> 3, hh = (lane >> 1) & 3, wg = lane & 1;
  const int d = sd0 + dd, h = sh0 + hh, wl = sw0 + wg * kLW;
  const float px = axis_pos(d, res, hw), py = axis_pos(h, res, hw);
  float pz[kWide ? 1 : kLW];
#pragma unroll
  for (int i = 0; i < (kWide ? 1 : kLW); ++i) pz[i] = axis_pos(wl + i, res, hw);

  const int nvc = a.vp / kChunk;
  const float* a_row = a.atoms + static_cast<size_t>(b) * 8 * a.vp;
  const float* w_row = a.weights + static_cast<size_t>(b) * a.channels * a.vp;

  // The active chunks, in chunk order, held by every warp at once (no
  // barrier): lane L keeps the mask of chunks 32 L .. 32 L + 31 whose range,
  // on any plane-range row the tile's rows meet, reaches the tile's planes.
  // The ranges of kSegs segments of 32 chunks are loaded before any is used.
  unsigned my_mask = 0u;
  {
    constexpr int kSegs = 4;
    const int2* r_row = reinterpret_cast<const int2*>(a.ranges) + static_cast<size_t>(b) * a.nhr * nvc;
    const int r_lo = h0 / a.hr, r_hi = h_last / a.hr;
    for (int seg0 = 0; seg0 * 32 < nvc; seg0 += kSegs) {
      bool act[kSegs];
#pragma unroll
      for (int q = 0; q < kSegs; ++q) act[q] = false;
      for (int rr = r_lo; rr <= r_hi; ++rr) {
        int2 r[kSegs];
#pragma unroll
        for (int q = 0; q < kSegs; ++q) {
          const int vc = (seg0 + q) * 32 + lane;
          r[q] = vc < nvc ? __ldg(r_row + static_cast<size_t>(rr) * nvc + vc) : make_int2(a.dl, 0);
        }
#pragma unroll
        for (int q = 0; q < kSegs; ++q) act[q] = act[q] || (r[q].y > d0 && r[q].x <= d_last);
      }
#pragma unroll
      for (int q = 0; q < kSegs; ++q) {
        const unsigned m = __ballot_sync(0xffffffffu, act[q]);
        if (lane == seg0 + q) my_mask = m;
      }
    }
  }
  const int my_cnt = __popc(my_mask);
  int n_act;
  const int my_incl = warp_scan_incl(my_cnt, lane, n_act);
  // chunk n of the active list (n < n_act), uniform across the warp
  auto nth_chunk = [&](int n) {
    const int seg = __popc(__ballot_sync(0xffffffffu, my_incl <= n));
    const unsigned m = __shfl_sync(0xffffffffu, my_mask, seg);
    const int before = __shfl_sync(0xffffffffu, my_incl - my_cnt, seg);
    return seg * 32 + static_cast<int>(__fns(m, 0, n - before + 1));
  };

  float acc[kLW][kCT];
#pragma unroll
  for (int i = 0; i < kLW; ++i)
#pragma unroll
    for (int k = 0; k < kCT; ++k) acc[i][k] = 0.0f;

  float4* wat = s_wat + warp * kTileWarpCap;
  float* wcf = s_wcf + warp * kTileWarpCap;
  float* wwt = s_ww + warp * kTileWarpCap * kCT;
  float* tab = s_tab + warp * kTileWarpCap * kPer;

  // Deposit the warp's list of n atoms: their factor tables over the
  // sub-brick (gaussian), then every lane's voxels, atom by atom in list
  // order.
  auto deposit_list = [&](int n) {
    __syncwarp();  // the list is written
    for (int e = lane; kGaussian && e < n * kPer; e += 32) {
      const int k = e / kPer, i = e - k * kPer;
      const float4 at = wat[k];
      int idx;
      float p;
      if (i < kTileSide) {
        idx = sd0 + i, p = at.x;
      } else if (i < 2 * kTileSide) {
        idx = sh0 + i - kTileSide, p = at.y;
      } else {
        idx = sw0 + i - 2 * kTileSide, p = at.z;
      }
      const float dv = __fsub_rn(axis_pos(idx, res, hw), p);
      const float d2 = __fmul_rn(dv, dv);
      // a factor beyond r2_thresh on its own axis is never used: the cutoff rejects it
      tab[e] = d2 <= at.w ? expf(d2 * wcf[k]) : 0.0f;
    }
    __syncwarp();
    for (int k = 0; k < n; ++k) {
      const float4 at = wat[k];
      const float dx = __fsub_rn(px, at.x);
      const float dx2 = __fmul_rn(dx, dx);
      const float th = __fsub_rn(at.w, dx2);
      const float dy = __fsub_rn(py, at.y);
      const float dy2 = __fmul_rn(dy, dy);
      if (dy2 > th) continue;  // dyz2 >= dy2: the atom misses the lane's row
      const float* tk = tab + k * kPer;
      const float* ez = tk + 2 * kTileSide + wg * kLW;
      float mk[kCT];
      if (kGaussian) {
        const float m = tk[dd] * tk[kTileSide + hh];
#pragma unroll
        for (int c = 0; c < kCT; ++c) mk[c] = wwt[k * kCT + c] * m;
      } else {
#pragma unroll
        for (int c = 0; c < kCT; ++c) mk[c] = wwt[k * kCT + c];
      }
#pragma unroll
      for (int i = 0; i < kLW; ++i) {
        const float dz = __fsub_rn(kWide ? axis_pos(wl + i, res, hw) : pz[kWide ? 0 : i], at.z);
        const float dyz2 = __fadd_rn(dy2, __fmul_rn(dz, dz));
        if (dyz2 <= th) {
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            if (kGaussian) {
              acc[i][c] = fmaf(mk[c], ez[i], acc[i][c]);
            } else {
              acc[i][c] += mk[c];
            }
          }
        }
      }
    }
    __syncwarp();  // the tables and the list are read; the next list may overwrite them
  };

  // Process the block's kept list [0, nk): each warp takes, in list order,
  // the atoms that reach its sub-brick, kTileWarpCap at a time.
  auto process = [&](int nk) {
    __syncthreads();  // the block's list is written
    if (warp_live) {
      int nw = 0;
      for (int base = 0; base < nk; base += 32) {
        const int j = base + lane;
        bool keep = false;
        if (j < nk) {
          keep = reaches(s_blk[j], s_blk[cap + j], s_blk[2 * cap + j], s_blk[3 * cap + j], wlo, whi);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        const int cnt = __popc(bal);
        if (nw + cnt > kTileWarpCap) {  // uniform: deposit what the list holds first
          deposit_list(nw);
          nw = 0;
        }
        if (keep) {
          const int slot = nw + __popc(bal & ((1u << lane) - 1u));
          wat[slot] = make_float4(s_blk[j], s_blk[cap + j], s_blk[2 * cap + j], s_blk[3 * cap + j]);
          wcf[slot] = s_blk[4 * cap + j];
#pragma unroll
          for (int c = 0; c < kCT; ++c) wwt[slot * kCT + c] = s_blk[(kRows + c) * cap + j];
        }
        nw += cnt;
      }
      if (nw > 0) deposit_list(nw);
    }
    __syncthreads();  // every warp has read the block's list; the next round may overwrite it
  };

  // Culling in rounds: warp w tests chunk r0 + w of the active list against
  // the block's tile, two atoms a lane, straight from global memory; after
  // one barrier each warp knows where its keepers go, so the block's list
  // is in chunk order, then atom order.
  int nkeep = 0, par = 0;
  for (int r0 = 0; r0 < n_act; r0 += nwarps) {
    float v[2][kCols];
    bool keep_it[2] = {false, false};
    if (r0 + warp < n_act) {
      const size_t off = static_cast<size_t>(nth_chunk(r0 + warp)) * kChunk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const size_t j = off + lane + 32 * half;
#pragma unroll
        for (int col = 0; col < kRows; ++col) v[half][col] = __ldg(a_row + static_cast<size_t>(col) * a.vp + j);
        bool weighted = false;
#pragma unroll
        for (int k = 0; k < kCT; ++k) {
          const int c = c0 + k;
          v[half][kRows + k] = c < a.channels ? __ldg(w_row + static_cast<size_t>(c) * a.vp + j) : 0.0f;
          weighted |= v[half][kRows + k] != 0.0f;
        }
        // an atom with no weight in these channels (masked, or another
        // channel's virtual atom) adds nothing
        keep_it[half] = weighted && reaches(v[half][0], v[half][1], v[half][2], v[half][3], blo, bhi);
      }
    }
    const unsigned kb0 = __ballot_sync(0xffffffffu, keep_it[0]), kb1 = __ballot_sync(0xffffffffu, keep_it[1]);
    if (lane == 0) s_cnt[par][warp] = __popc(kb0) + __popc(kb1);
    __syncthreads();
    int at = 0, total = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int ci = s_cnt[par][i];
      if (i < warp) at += ci;
      total += ci;
    }
    par ^= 1;
    if (nkeep + total > cap) {  // uniform: process what is kept first
      process(nkeep);
      nkeep = 0;
    }
    at += nkeep;
    const unsigned lower = (1u << lane) - 1u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (keep_it[half]) {
        const int slot = at + (half ? __popc(kb0) : 0) + __popc((half ? kb1 : kb0) & lower);
#pragma unroll
        for (int col = 0; col < kCols; ++col) s_blk[col * cap + slot] = v[half][col];
      }
    }
    nkeep += total;
  }
  if (nkeep > 0) process(nkeep);

  if (!warp_live || d >= a.dl || h >= a.dim || wl >= a.dim) return;
  OutT* const out = static_cast<OutT*>(a.out);
  const size_t plane = static_cast<size_t>(a.dim) * a.dim;
  const bool vec = (a.dim * sizeof(OutT)) % kStoreBytes == 0;  // every row starts 16-byte aligned
  constexpr int R = kStoreBytes / sizeof(OutT);
#pragma unroll
  for (int k = 0; k < kCT; ++k) {
    if (c0 + k >= a.channels) continue;
    OutT* dst = out + ((static_cast<size_t>(b) * a.channels + c0 + k) * a.dl + d) * plane +
                static_cast<size_t>(h) * a.dim + wl;
#pragma unroll
    for (int r0 = 0; r0 < kLW; r0 += R) {
      float v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = acc[r0 + i][k];
      if (vec && wl + r0 + R <= a.dim) {
        store_run<OutT, R>(dst + r0, v);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (wl + r0 + i < a.dim) dst[r0 + i] = cast_out<OutT>(v[i]);  // the ragged edge
      }
    }
  }
}

using Kernel = void (*)(Args);

// The kernel for kCT channels, or nullptr where R * kCT values exceed the
// accumulator budget (16 fp8 values x 4 channels, 8 bf16 values x 8).
template <bool kGaussian, int kCT, typename OutT>
Kernel kernel_or_null() {
  if constexpr (kStoreBytes / sizeof(OutT) * kCT <= kAccMax) {
    return deposit_fwd_kernel<kGaussian, kCT, OutT>;
  } else {
    return nullptr;
  }
}

template <typename OutT>
Kernel pick(int gaussian, int kct) {
  switch (kct) {
    case 1:
      return gaussian ? kernel_or_null<true, 1, OutT>() : kernel_or_null<false, 1, OutT>();
    case 2:
      return gaussian ? kernel_or_null<true, 2, OutT>() : kernel_or_null<false, 2, OutT>();
    case 4:
      return gaussian ? kernel_or_null<true, 4, OutT>() : kernel_or_null<false, 4, OutT>();
    case 8:
      return gaussian ? kernel_or_null<true, 8, OutT>() : kernel_or_null<false, 8, OutT>();
    default:
      return nullptr;
  }
}

Kernel pick_kernel(int out_kind, int gaussian, int kct) {
  if (out_kind == 0) return pick<float>(gaussian, kct);
  if (out_kind == 1) return pick<__nv_bfloat16>(gaussian, kct);
  return pick<__nv_fp8_storage_t>(gaussian, kct);
}

size_t smem_bytes(int gaussian, int kct, const Args& a) {
  const size_t floats = (kStages + 1) * (kRows + kct) * kChunk + (gaussian ? kGroup * (a.dt + a.ht + a.dim) : 0);
  return floats * sizeof(float);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory; above 48 KB this
// needs cudaFuncSetAttribute, set once for each kernel and size.
int allow_smem(Kernel kernel, size_t smem) {
  static Kernel seen[32];
  static size_t opted[32];
  if (smem <= 40 * 1024) return 0;
  int i = 0;
  while (i < 32 && seen[i] != nullptr && seen[i] != kernel) ++i;
  if (i < 32 && seen[i] == kernel && opted[i] >= smem) return 0;
  const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (i < 32) seen[i] = kernel, opted[i] = smem;
  return 0;
}

int elem_size(int out_kind) { return out_kind == 0 ? 4 : out_kind == 1 ? 2 : 1; }

bool misaligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

// Fills the launch arguments from the brick, or returns a cudaError_t.
int make_args(Args* a, const void* atoms, const void* weights, const void* ranges, void* out, int batch, int vp,
              int channels, int dl, int dim, float res, float half_width, int out_kind, int kct, int threads,
              int dt, int ht, int passes, long long* blocks) {
  if (batch <= 0 || vp <= 0 || vp % kChunk != 0 || channels <= 0 || dl <= 0 || dim <= 0 || out_kind < 0 ||
      out_kind > 2 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 || dt < 1 || dt > dl || ht < 1 ||
      ht > dim || passes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(atoms, kStoreBytes) || misaligned(weights, kStoreBytes) || misaligned(out, kStoreBytes) ||
      misaligned(ranges, 8)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int run = kStoreBytes / elem_size(out_kind);
  a->atoms = static_cast<const float*>(atoms);
  a->weights = static_cast<const float*>(weights);
  a->ranges = static_cast<const int*>(ranges);
  a->out = out;
  a->vp = vp, a->channels = channels, a->dl = dl, a->dim = dim;
  a->nct = (channels + kct - 1) / kct;
  a->dt = dt, a->ht = ht;
  a->ndt = (dl + dt - 1) / dt, a->nht = (dim + ht - 1) / ht;
  a->nrun = (dim + run - 1) / run;
  a->passes = passes;
  a->res = res, a->half_width = half_width;
  if (passes * run * kct > kAccMax ||
      static_cast<long long>(dt) * ht * a->nrun > static_cast<long long>(threads) * passes) {
    return static_cast<int>(cudaErrorInvalidValue);  // over the accumulator budget, or the passes miss a run
  }
  *blocks = static_cast<long long>(batch) * a->nct * a->ndt * a->nht;
  if (*blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

using TileKernel = void (*)(TileArgs);

template <bool kGaussian, int kCT, int kLW, typename OutT>
TileKernel tile_kernel_or_null() {
  if constexpr (kLW * kCT <= kAccMax) {
    return deposit_fwd_tile_kernel<kGaussian, kCT, kLW, OutT>;
  } else {
    return nullptr;
  }
}

template <int kLW, typename OutT>
TileKernel pick_tile_width(int gaussian, int kct) {
  switch (kct) {
    case 1:
      return gaussian ? tile_kernel_or_null<true, 1, kLW, OutT>() : tile_kernel_or_null<false, 1, kLW, OutT>();
    case 2:
      return gaussian ? tile_kernel_or_null<true, 2, kLW, OutT>() : tile_kernel_or_null<false, 2, kLW, OutT>();
    case 4:
      return gaussian ? tile_kernel_or_null<true, 4, kLW, OutT>() : tile_kernel_or_null<false, 4, kLW, OutT>();
    default:
      return nullptr;
  }
}

// lw: the lane's run of w, narrow (tile_lane_w) or wide (twice that).
template <typename OutT>
TileKernel pick_tile(int gaussian, int kct, int lw) {
  constexpr int kNarrow = tile_lane_w<OutT>();
  if (lw == kNarrow) return pick_tile_width<kNarrow, OutT>(gaussian, kct);
  if (lw == 2 * kNarrow) return pick_tile_width<2 * kNarrow, OutT>(gaussian, kct);
  return nullptr;
}

TileKernel pick_tile_kernel(int out_kind, int gaussian, int kct, int lw) {
  if (out_kind == 0) return pick_tile<float>(gaussian, kct, lw);
  if (out_kind == 1) return pick_tile<__nv_bfloat16>(gaussian, kct, lw);
  return pick_tile<__nv_fp8_storage_t>(gaussian, kct, lw);
}

size_t tile_smem_bytes(int kct, int warps, int lw) {
  const size_t per = 2 * kTileSide + 2 * lw;  // table entries of an atom
  return (static_cast<size_t>(warps) * kTileWarpCap * (4 + per + 1 + kct) +
          static_cast<size_t>(kRows + kct) * warps * kChunk) * sizeof(float);
}

int allow_tile_smem(TileKernel kernel, size_t smem) {
  static TileKernel seen[32];
  static size_t opted[32];
  if (smem <= 40 * 1024) return 0;
  int i = 0;
  while (i < 32 && seen[i] != nullptr && seen[i] != kernel) ++i;
  if (i < 32 && seen[i] == kernel && opted[i] >= smem) return 0;
  const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (i < 32) seen[i] = kernel, opted[i] = smem;
  return 0;
}

// Fills the tile launch arguments, or returns a cudaError_t.
int make_tile_args(TileArgs* a, const void* atoms, const void* weights, const void* ranges, void* out, int batch,
                   int vp, int channels, int dl, int dim, float res, float half_width, int out_kind, int kct, int lw,
                   int bd, int bh, int bw, int hr, long long* blocks) {
  if (batch <= 0 || vp <= 0 || vp % kChunk != 0 || channels <= 0 || dl <= 0 || dim <= 0 || out_kind < 0 ||
      out_kind > 2 || lw < 1 || bd < 1 || bh < 1 || bw < 1 || bd * bh * bw * 32 > kMaxThreads || hr < 1 ||
      hr > dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(atoms, kStoreBytes) || misaligned(weights, kStoreBytes) || misaligned(out, kStoreBytes) ||
      misaligned(ranges, 8)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  a->atoms = static_cast<const float*>(atoms);
  a->weights = static_cast<const float*>(weights);
  a->ranges = static_cast<const int*>(ranges);
  a->out = out;
  a->vp = vp, a->channels = channels, a->dl = dl, a->dim = dim;
  a->nct = (channels + kct - 1) / kct;
  a->bd = bd, a->bh = bh, a->bw = bw;
  a->ndt = (dl + kTileSide * bd - 1) / (kTileSide * bd);
  a->nht = (dim + kTileSide * bh - 1) / (kTileSide * bh);
  a->nwt = (dim + 2 * lw * bw - 1) / (2 * lw * bw);
  a->hr = hr, a->nhr = (dim + hr - 1) / hr;
  a->res = res, a->half_width = half_width;
  *blocks = static_cast<long long>(batch) * a->nct * a->ndt * a->nht * a->nwt;
  if (*blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

extern "C" {

// Constants the Python side plans bricks with (molvoxel_torch/ops/deposit.py).
int deposit_fwd_chunk() { return kChunk; }
int deposit_fwd_max_threads() { return kMaxThreads; }
int deposit_fwd_acc_max() { return kAccMax; }
int deposit_fwd_store_bytes() { return kStoreBytes; }

// out_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.  The brick: kct
// channels (1, 2, 4 or 8), threads a block, dt planes x ht rows, and the
// passes of the threads over it.  Returns the cudaError_t of the launch (0
// on success); nothing is synchronised.
int deposit_fwd(const void* atoms, const void* weights, const void* ranges, void* out, int batch, int vp,
                int channels, int dl, int dim, float res, float half_width, int gaussian, int out_kind, int kct,
                int threads, int dt, int ht, int passes, void* stream) {
  Args a;
  long long blocks = 0;
  int rc = make_args(&a, atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, out_kind, kct,
                     threads, dt, ht, passes, &blocks);
  if (rc != 0) return rc;
  const Kernel kernel = pick_kernel(out_kind, gaussian, kct);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(gaussian, kct, a);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                           dim3(threads), args, smem, static_cast<cudaStream_t>(stream)));
}

// The blocks of this brick's launch, and how many of them one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a
// cudaError_t.
int deposit_fwd_blocks(int batch, int vp, int channels, int dl, int dim, int gaussian, int out_kind, int kct,
                       int threads, int dt, int ht, int passes, long long* blocks, int* resident_per_sm) {
  alignas(16) static float probe[4];
  Args a;
  int rc = make_args(&a, probe, probe, probe, probe, batch, vp, channels, dl, dim, 1.0f, 0.0f, out_kind, kct,
                     threads, dt, ht, passes, blocks);
  if (rc != 0) return rc;
  const Kernel kernel = pick_kernel(out_kind, gaussian, kct);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(gaussian, kct, a);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_per_sm, reinterpret_cast<const void*>(kernel), threads, smem));
}

// Constants of the tile launch: planes and rows of a warp's sub-brick, and
// atoms a warp deposits per fill of its tables.
int deposit_fwd_tile_side() { return kTileSide; }
int deposit_fwd_tile_warp_cap() { return kTileWarpCap; }

// The tile launch (molecules of more than one chunk): blocks of bd x bh x
// bw warps, each warp 4 planes x 4 rows x 2 lw columns, each lane lw
// consecutive w (8 or 16; fp8 16 or 32), kct channels (kct x lw at most
// 32); ranges at hr rows.  Returns the cudaError_t of the launch (0 on
// success); nothing is synchronised.
int deposit_fwd_tile(const void* atoms, const void* weights, const void* ranges, void* out, int batch, int vp,
                     int channels, int dl, int dim, float res, float half_width, int gaussian, int out_kind, int kct,
                     int lw, int bd, int bh, int bw, int hr, void* stream) {
  TileArgs a;
  long long blocks = 0;
  int rc = make_tile_args(&a, atoms, weights, ranges, out, batch, vp, channels, dl, dim, res, half_width, out_kind,
                          kct, lw, bd, bh, bw, hr, &blocks);
  if (rc != 0) return rc;
  const TileKernel kernel = pick_tile_kernel(out_kind, gaussian, kct, lw);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(kct, bd * bh * bw, lw);
  if ((rc = allow_tile_smem(kernel, smem)) != 0) return rc;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                           dim3(32 * bd * bh * bw), args, smem, static_cast<cudaStream_t>(stream)));
}

// The blocks of the tile launch, and how many of them one SM holds at once.
// Returns a cudaError_t.
int deposit_fwd_tile_blocks(int batch, int vp, int channels, int dl, int dim, int gaussian, int out_kind, int kct,
                            int lw, int bd, int bh, int bw, int hr, long long* blocks, int* resident_per_sm) {
  alignas(16) static float probe[4];
  TileArgs a;
  int rc = make_tile_args(&a, probe, probe, probe, probe, batch, vp, channels, dl, dim, 1.0f, 0.0f, out_kind, kct,
                          lw, bd, bh, bw, hr, blocks);
  if (rc != 0) return rc;
  const TileKernel kernel = pick_tile_kernel(out_kind, gaussian, kct, lw);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(kct, bd * bh * bw, lw);
  if ((rc = allow_tile_smem(kernel, smem)) != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_per_sm, reinterpret_cast<const void*>(kernel), 32 * bd * bh * bw, smem));
}

}  // extern "C"
