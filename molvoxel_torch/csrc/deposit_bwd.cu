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
// almost-everywhere gradient).  Binary density writes grad_w only.  Atoms
// with zero weight still get their weight gradient.
//
// Inputs (molvoxel_torch/ops/deposit.py):
//   atoms   (B, 8, Vp) f32 rows [x', y, z, r2_thresh, coef, 0, 0, 0]
//   weights (B, C, Vp) f32
//   ct      (B, C, Dl, H*W) f32, or bf16 (the low-precision lane)
// Outputs: grad_rows (B, 8, Vp) f32, grad_w (B, C, Vp) f32, every element
// written exactly once.
//
// What bounds it on an H100 SXM: the cotangent voxels the atoms reach, read
// once at 3.35 TB/s, and a few FP32 operations per in-cutoff (atom, voxel)
// pair; on the training batch both are far below the launch itself.  What
// held the first version back was latency: one warp walked an atom's whole
// cutoff box (about 343 voxels at r/res = 2, of which about 33 lie inside),
// so a lane made about 11 passes, each a dependent cotangent load behind a
// divergent branch, two integer divisions and three expf.  This version's
// time on the training batch is the chain of dependent steps each warp
// runs (staging, box, planes, rows, pairs, reductions), 31 warps an SM.
//
// Design.
// - Work item: a block of 8 warps owns 8 / wpa atoms of one molecule, wpa
//   warps an atom (the wrapper picks wpa: 1 on batches with thousands of
//   atoms, up to 8 where few atoms must fill the card).  The item is
//   blockIdx.x, so no grid axis caps the batch.  The block stages its
//   atoms' five rows and C weights in shared memory with one coalesced pass.
// - Enumerate only what the sphere can reach, in closed form at each level:
//   the atom's box (its reach widened by one voxel each side, clipped to the
//   grid or slab) gives its planes; lane L takes plane L and its h-span from
//   th - dx^2 (widened by one voxel, clipped to the box; empty where
//   th - dx^2 < 0); a warp prefix sum over the h-spans numbers the rows, and
//   warp `part` of the atom takes a contiguous share of them, 32 at a time:
//   lane L finds its row's plane as the count of planes whose rows end below
//   it (a ballot and an OR reduction, owner_rank) and takes the row's w-span
//   from th - dx^2 - dy^2 (widened, clipped; empty where dy^2 > th - dx^2).
//   A second prefix sum over the w-spans numbers the (row, w) pairs: pair p
//   goes to lane p % 32, which finds its row the same way and reads the
//   row's terms from shared memory.  Consecutive lanes read
//   consecutive columns of a row, so a load touches few 128-byte lines.  No
//   integer division per voxel; the exact predicate of deposit_fwd.cu
//   (__fsub_rn / __fmul_rn / __fadd_rn in the same order) still decides
//   each pair.  At r/res = 2 an atom has about 12 rows with pairs and 58
//   pairs, 33 of them inside the cutoff.
// - Loads before use: a lane takes kPairs pairs at a time and starts the
//   cotangent loads of all of them (every channel of the group) before any
//   arithmetic on them, keeping only each pair's row and column meanwhile.
//   Two pairs a lane, but one at 4 channels: there two spill at the 64
//   registers that 4 blocks an SM allow, and cost more than a second batch.
// - Separable factors: ex[i], ey[h] and ez[w] tabulated once per warp over
//   the box (kTab entries an axis; wider boxes take expf directly, with the
//   same bits), so a pair costs no expf and f = ex * (ey * ez), the first
//   version's product.
// - Channels: groups of up to kCT (1, 4 or 8) inside the work item; each
//   group adds its share of Q f to the coordinate sums, which are linear
//   in Q.  (x - g) is taken per voxel: no moment sums about the grid origin,
//   which cancel badly in f32.
// - Reduction: a fixed xor-shuffle tree per warp (recursive halving, so C
//   sums take about C shuffles, not 5 C), then the wpa warps of an atom
//   summed in warp order through shared memory; one thread writes each
//   gradient element.  No atomics: two launches give identical bits.
//
// Threshold rows (gaussian_notrunc: a reach of about 3.2 r, about 1,100
// voxels at r/res = 2 against 33 at the exact cutoff) take a second kernel,
// deposit_bwd_notrunc_kernel.  There the walk above spends 80% of its time
// on pairs, 32 a batch, each batch an owner search, two record reads, four
// scattered 4-byte loads (one a channel) and the arithmetic; the bytes are
// not what bounds it (a bf16 cotangent takes as long).  So the threshold
// rows keep the walk's blocks, atoms, planes and rows, but:
// - each row's w-span is cut into groups of 4 aligned columns and a lane
//   takes a group: one 16-byte load a channel (8 bytes for bf16), so a
//   batch covers 128 voxels for one owner search and one set of reads;
// - (dz, ez) of every column of the atom's box, from its group-aligned
//   start, come from the warp's table (two 16-byte reads a group), so a
//   voxel costs no position arithmetic and no expf;
// - sx and sy take the group's sum of Q f once (its voxels share dx, dy).
// The exact predicate of deposit_fwd.cu decides each voxel; sums are f32
// in a fixed order, so two launches give identical bits.  Rows must be
// whole groups (W a multiple of 4) and the cotangent aligned for the vector
// loads: the wrapper keeps the walk above otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLgWarps = 3;  // a block: 8 warps
constexpr int kWarps = 1 << kLgWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;      // blocks an SM holds at C <= 4: all 4,096 warps of the training batch at once
constexpr int kMinBlocksWide = 2;  // ... with 8-channel groups, whose 64-register build spilled
constexpr int kTab = 64;       // entries a warp tabulates of ex, ey and ez
constexpr int kRows = 5;       // atom rows read: x', y, z, r2_thresh, coef
constexpr float kSlack = 1.0001f;  // a reach is sqrt(r2) * kSlack + kPad, then one voxel each side
constexpr float kPad = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* atoms;
  const float* weights;
  const void* ct;
  float* grad_rows;
  float* grad_w;
  int vp, channels, dl, dim, lg_wpa;  // warps per atom: 1 << lg_wpa
  float res, inv_res, half_width;     // inv_res = 1 / res, rounded
};

// Voxel-center position idx*res - half_width, rounded like the forward.
__device__ __forceinline__ float axis_pos(int idx, float res, float half_width) {
  return __fsub_rn(__fmul_rn(static_cast<float>(idx), res), half_width);
}

// sqrt(max(r2, 0)) with slack, rounded step by step (no FMA), so that a
// float32 copy of the span formula (tests/test_torch_deposit.py) gives the
// same bits.
__device__ __forceinline__ float slack_reach(float r2) {
  return __fadd_rn(__fmul_rn(sqrtf(fmaxf(r2, 0.0f)), kSlack), kPad);
}

// [lo, hi]: the indices in [0, n) whose voxel centre lies within `reach` of
// p, widened by one voxel on each side (inv_res = 1 / res, rounded); empty
// when hi < lo.  Clamped in float first, so far-off padding atoms and huge
// inputs convert safely.
__device__ __forceinline__ void span(float p, float reach, float inv_res, float half_width, int n, int& lo,
                                     int& hi) {
  const float flo = ceilf(__fmul_rn(__fadd_rn(__fsub_rn(p, reach), half_width), inv_res)) - 1.0f;
  const float fhi = floorf(__fmul_rn(__fadd_rn(__fadd_rn(p, reach), half_width), inv_res)) + 1.0f;
  lo = static_cast<int>(fminf(fmaxf(flo, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fmaxf(fminf(fhi, static_cast<float>(n - 1)), -1.0f));
}

__device__ __forceinline__ float load_ct(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ct(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Inclusive prefix sum of v over the lanes, and the warp's total.  (One
// ballot per bit of the largest v took 7% longer on the training batch.)
__device__ __forceinline__ int warp_scan(int v, int lane, int& total) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  total = __shfl_sync(kFull, v, 31);
  return v;
}

// Items numbered by the lanes' inclusive prefix sums `incl` (lane L holds
// items incl - n .. incl - 1, n > 0 where `has`): the rank, among the lanes
// that have items, of the lane holding item base + lane.  It is the number
// of those lanes whose last item lies below: one ballot, one OR reduction.
__device__ __forceinline__ int owner_rank(bool has, int incl, int base, int lane) {
  const int last = incl - 1 - base;  // this lane's last item, in the window's lanes
  const unsigned ends = __reduce_or_sync(kFull, has && last >= 0 && last < 32 ? 1u << last : 0u);
  const int rank = __popc(__ballot_sync(kFull, has && last < 0)) + __popc(ends & ((1u << lane) - 1u));
  return min(rank, 31);  // past the last item: any lane, unused
}

// Sums each of v[0..N) over the warp in a fixed tree (N a power of two, at
// most 32) with N + 4 - log2(N) shuffles: at each of the first log2(N)
// levels a lane keeps half of its values and adds its partner's copy of
// them (recursive halving).  Lane L ends with the total of value L / (32 / N).
template <int N>
__device__ __forceinline__ float warp_sums(float (&v)[N], int lane) {
  int offset = 16;
#pragma unroll
  for (int half = N / 2; half >= 1; half /= 2, offset /= 2) {
    const bool upper = lane & offset;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, offset);
    }
  }
  float total = v[0];
#pragma unroll
  for (; offset > 0; offset /= 2) total += __shfl_xor_sync(kFull, total, offset);
  return total;
}

template <bool kGaussian, int kCT, typename CtT>
__global__ void __launch_bounds__(kThreads, kCT == 8 ? kMinBlocksWide : kMinBlocks)
    deposit_bwd_kernel(const Args a) {
  // pairs a lane loads before it uses any: 2, but 1 at 4 channels, where 2 spill at 64 registers
  constexpr int kPairs = kCT == 4 ? 1 : 2;
  const int lg_wpa = a.lg_wpa, wpa = 1 << lg_wpa, lg_apb = kLgWarps - lg_wpa, nch = a.channels, nred = nch + 4;
  extern __shared__ float smem[];
  float* s_w = smem;                       // [C][apb] the block's weights
  float* s_red = s_w + (nch << lg_apb);    // [kWarps][C + 4] each warp's sums: grad_w, then sx, sy, sz, sd
  __shared__ float s_atom[kRows][kWarps];
  __shared__ float s_ex[kWarps][kTab], s_ey[kWarps][kTab], s_ez[kWarps][kTab];
  __shared__ int2 s_planes[kWarps][32];                      // a warp's planes with rows: plane, h - rho
  __shared__ float4 s_rec[kWarps][32], s_rec2[kWarps][32];  // its rows with pairs: dx, dy, dx^2, dy^2; th - dx^2, ex, ey, wofs
  __shared__ int s_voff[kWarps][32];                         // and their first voxel

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int items = a.vp >> lg_apb;
  const int b = blockIdx.x / items;
  const int v0 = (blockIdx.x - b * items) << lg_apb;
  {
    const float* a_row = a.atoms + static_cast<size_t>(b) * 8 * a.vp + v0;
    const float* w_row = a.weights + static_cast<size_t>(b) * nch * a.vp + v0;
#pragma unroll 1
    for (int e = t; e < (kRows + nch) << lg_apb; e += kThreads) {
      const int row = e >> lg_apb, j = e & ((1 << lg_apb) - 1);
      if (row < kRows) {
        s_atom[row][j] = a_row[static_cast<size_t>(row) * a.vp + j];
      } else {
        s_w[e - (kRows << lg_apb)] = w_row[static_cast<size_t>(row - kRows) * a.vp + j];
      }
    }
  }
  __syncthreads();

  const int j = warp >> lg_wpa, part = warp & (wpa - 1);  // this warp's atom, and its share of the atom's rows
  const float x = s_atom[0][j], y = s_atom[1][j], z = s_atom[2][j], th = s_atom[3][j], cf = s_atom[4][j];
  const float res = a.res, inv_res = a.inv_res, hw = a.half_width;
  const float reach = slack_reach(th);
  int dlo, dhi, hlo, hhi, wlo, whi;
  span(x, reach, inv_res, hw, a.dl, dlo, dhi);
  span(y, reach, inv_res, hw, a.dim, hlo, hhi);
  span(z, reach, inv_res, hw, a.dim, wlo, whi);
  const int nd = (dhi >= dlo && hhi >= hlo && whi >= wlo) ? dhi - dlo + 1 : 0;  // planes of the box
  // the factor tables ex[i], ey[h], ez[w] over the box (kTab entries an
  // axis; beyond, expf directly: the same bits)
  const int ntab_x = kGaussian ? min(max(dhi - dlo + 1, 0), kTab) : 0;
  const int ntab_y = kGaussian ? min(max(hhi - hlo + 1, 0), kTab) : 0;
  const int ntab = kGaussian ? min(max(whi - wlo + 1, 0), kTab) : 0;
  for (int e = lane; e < max(max(ntab_x, ntab_y), ntab); e += 32) {
    const float dx = __fsub_rn(axis_pos(dlo + e, res, hw), x), dy = __fsub_rn(axis_pos(hlo + e, res, hw), y);
    const float dz = __fsub_rn(axis_pos(wlo + e, res, hw), z);
    const float dx2 = __fmul_rn(dx, dx), dy2 = __fmul_rn(dy, dy), dz2 = __fmul_rn(dz, dz);
    s_ex[warp][e] = expf(dx2 * cf);
    s_ey[warp][e] = expf(dy2 * cf);
    s_ez[warp][e] = expf(dz2 * cf);
  }
  __syncwarp();

  const size_t plane = static_cast<size_t>(a.dim) * a.dim;
  const size_t c_stride = static_cast<size_t>(a.dl) * plane;
  const CtT* ct_b = static_cast<const CtT*>(a.ct) + static_cast<size_t>(b) * nch * c_stride;
  float* red = s_red + warp * nred;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sd = 0.0f;

  for (int c0 = 0; c0 < nch; c0 += kCT) {
    const int nc = min(kCT, nch - c0);  // channels of this group
    const CtT* ct_g = ct_b + c0 * c_stride;
    float wk[kCT], gw[kCT];
#pragma unroll
    for (int k = 0; k < kCT; ++k) {
      wk[k] = k < nc ? s_w[((c0 + k) << lg_apb) + j] : 0.0f;
      gw[k] = 0.0f;
    }
    for (int pc = 0; pc < nd; pc += 32) {
      // Lane L takes plane dlo + pc + L: its terms, and its h-span in closed
      // form from th - dx^2 (widened by one voxel, clipped to the box), empty
      // where th - dx^2 < 0 (exact: no voxel of the plane can pass).
      int hl = 0, hn = 0;
      if (pc + lane < nd) {
        const float dx = __fsub_rn(axis_pos(dlo + pc + lane, res, hw), x);
        const float t_th = __fsub_rn(th, __fmul_rn(dx, dx));
        if (t_th >= 0.0f) {
          int hr;
          span(y, slack_reach(t_th), inv_res, hw, a.dim, hl, hr);
          hl = max(hl, hlo);
          hn = max(min(hr, hhi) - hl + 1, 0);
        }
      }
      int prows;
      const int pincl = warp_scan(hn, lane, prows);
      // the planes with rows, compacted in plane order: their index and h - rho of their rows
      const bool phas = hn > 0;
      const int prank = __popc(__ballot_sync(kFull, phas) & ((1u << lane) - 1u));  // every lane votes
      if (phas) s_planes[warp][prank] = make_int2(pc + lane, hl - (pincl - hn));
      __syncwarp();
      const int share = (prows + wpa - 1) >> lg_wpa;  // this warp's rows: [part * share, min(prows, ...))
      const int rend = min(prows, (part + 1) * share);

      for (int q0 = part * share; q0 < rend; q0 += 32) {
        // Lane L takes row rho = q0 + L: its plane (counting the planes whose
        // rows end below rho), its terms, its w-span (widened, clipped to the
        // box; empty where dy^2 > th - dx^2) and factors, written to shared
        // memory for the lanes of its pairs.
        const int rho = q0 + lane;
        const int2 plane_of = s_planes[warp][owner_rank(phas, pincl, q0, lane)];
        const int pl = plane_of.x, h = rho + plane_of.y;  // plane from dlo, and row
        const float dx = __fsub_rn(axis_pos(dlo + pl, res, hw), x);
        const float dx2 = __fmul_rn(dx, dx);
        const float t_th = __fsub_rn(th, dx2);
        const float dy = __fsub_rn(axis_pos(h, res, hw), y);
        const float dy2 = __fmul_rn(dy, dy);
        int len = 0, lo = 0, voff = 0;
        if (rho < rend && dy2 <= t_th) {
          int hi;
          span(z, slack_reach(__fsub_rn(t_th, dy2)), inv_res, hw, a.dim, lo, hi);
          lo = max(lo, wlo);
          len = max(min(hi, whi) - lo + 1, 0);
          voff = ((dlo + pl) * a.dim + h) * a.dim;  // fits an int: checked at launch
        }
        int total;
        const int incl = warp_scan(len, lane, total);
        // the rows with pairs, compacted in row order: record `slot`, last pair incl - 1
        const bool has = len > 0;
        const int slot = __popc(__ballot_sync(kFull, has) & ((1u << lane) - 1u));
        if (has) {
          float ex = 0.0f, ey = 0.0f;
          if (kGaussian) {
            const unsigned ex_at = static_cast<unsigned>(pl), ey_at = static_cast<unsigned>(h - hlo);
            ex = ex_at < static_cast<unsigned>(ntab_x) ? s_ex[warp][ex_at] : expf(dx2 * cf);
            ey = ey_at < static_cast<unsigned>(ntab_y) ? s_ey[warp][ey_at] : expf(dy2 * cf);
          }
          s_rec[warp][slot] = make_float4(dx, dy, dx2, dy2);
          s_rec2[warp][slot] = make_float4(t_th, ex, ey, __int_as_float(lo - (incl - len)));
          s_voff[warp][slot] = voff;
        }
        __syncwarp();

        // kPairs pairs a lane at a time, in pair order: pair p = p0 + 32 k +
        // lane belongs to the row after the rows whose last pair is below p.
        // Every cotangent load of the batch is started before any arithmetic
        // on it.
        for (int p0 = 0; p0 < total; p0 += 32 * kPairs) {
          // the loads of every pair first, keeping only the pair's row and
          // column; its terms are read again from shared memory after
          float g[kPairs][kCT];
          int src[kPairs], w[kPairs];
          bool in[kPairs];
#pragma unroll
          for (int k = 0; k < kPairs; ++k) {
            const int p = p0 + 32 * k + lane;
            src[k] = owner_rank(has, incl, p0 + 32 * k, lane);
            const float4 ra = s_rec[warp][src[k]], rb = s_rec2[warp][src[k]];
            w[k] = p + __float_as_int(rb.w);
            const float dz = __fsub_rn(axis_pos(w[k], res, hw), z);
            in[k] = p < total && __fadd_rn(ra.w, __fmul_rn(dz, dz)) <= rb.x;
            const CtT* g_vox = ct_g + s_voff[warp][src[k]] + w[k];
#pragma unroll
            for (int c = 0; c < kCT; ++c) {
              g[k][c] = (in[k] && c < nc) ? load_ct(g_vox) : 0.0f;
              g_vox += c_stride;
            }
          }
#pragma unroll
          for (int k = 0; k < kPairs; ++k) {
            if (!in[k]) continue;
            if (kGaussian) {
              const float4 ra = s_rec[warp][src[k]], rb = s_rec2[warp][src[k]];
              const float dz = __fsub_rn(axis_pos(w[k], res, hw), z);
              const float dz2 = __fmul_rn(dz, dz);
              const float dyz2 = __fadd_rn(ra.w, dz2);
              const unsigned e = static_cast<unsigned>(w[k] - wlo);
              const float f = rb.y * (rb.z * (e < static_cast<unsigned>(ntab) ? s_ez[warp][e] : expf(dz2 * cf)));
              float q = 0.0f;
#pragma unroll
              for (int c = 0; c < kCT; ++c) {
                gw[c] += g[k][c] * f;
                q += g[k][c] * wk[c];
              }
              const float tq = q * f;
              sx -= tq * ra.x;
              sy -= tq * ra.y;
              sz -= tq * dz;
              sd += tq * (ra.z + dyz2);
            } else {
#pragma unroll
              for (int c = 0; c < kCT; ++c) gw[c] += g[k][c];
            }
          }
        }
        __syncwarp();  // the records are read; the next rows may overwrite them
      }
      __syncwarp();  // the planes are read; the next planes may overwrite them
    }
    const float total = warp_sums<kCT>(gw, lane);
    const int idx = lane / (32 / kCT);
    if (lane % (32 / kCT) == 0 && c0 + idx < nch) red[c0 + idx] = total;
  }
  if (kGaussian) {
    float sums[4] = {sx, sy, sz, sd};
    const float total = warp_sums<4>(sums, lane);
    if (lane % 8 == 0) red[nch + lane / 8] = total;
  }
  __syncthreads();

  // one thread per gradient element, atoms fastest: the wpa warps of an atom summed in warp order
#pragma unroll 1
  for (int e = t; e < (nch + 8) << lg_apb; e += kThreads) {
    const int val = e >> lg_apb, jj = e & ((1 << lg_apb) - 1);
    const float* part_sums = s_red + (jj << lg_wpa) * nred;
    if (val < nch) {
      float sum = part_sums[val];
      for (int p = 1; p < wpa; ++p) sum += part_sums[p * nred + val];
      a.grad_w[(static_cast<size_t>(b) * nch + val) * a.vp + v0 + jj] = sum;
    } else {
      const int row = val - nch;
      float g = 0.0f;
      if (kGaussian && (row < 3 || row == 4)) {
        const int col = nch + (row < 3 ? row : 3);
        float sum = part_sums[col];
        for (int p = 1; p < wpa; ++p) sum += part_sums[p * nred + col];
        g = row < 3 ? 2.0f * s_atom[4][jj] * sum : sum;
      }
      a.grad_rows[(static_cast<size_t>(b) * 8 + row) * a.vp + v0 + jj] = g;
    }
  }
}

constexpr int kGroup = 4;  // consecutive w a threshold-row lane takes: one 16-byte load a channel (8 for bf16)
static_assert(kGroup == 4, "the group's table reads are two float4");


// Four cotangent values at p (16-byte aligned for f32, 8-byte for bf16), widened to f32.
__device__ __forceinline__ float4 load_ct4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load_ct4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The threshold-row walk (gaussian only): deposit_bwd_kernel's blocks,
// atoms, planes and rows, but each row's w-span is cut into aligned groups
// of kGroup columns and a lane takes a group: one vector load a channel,
// then the exact predicate and the sums for each of its four voxels.  The
// warp's table holds (dz, ez) for every column of the atom's box, rounded
// out to whole groups, so a voxel costs no position arithmetic.  Rows need
// W * element size to be a multiple of 16 bytes (8 for bf16): the wrapper
// launches this kernel only then.
template <int kCT, typename CtT>
__global__ void __launch_bounds__(kThreads, kCT == 8 ? kMinBlocksWide : kMinBlocks)
    deposit_bwd_notrunc_kernel(const Args a) {
  const int lg_wpa = a.lg_wpa, wpa = 1 << lg_wpa, lg_apb = kLgWarps - lg_wpa, nch = a.channels, nred = nch + 4;
  extern __shared__ float smem[];
  float* s_w = smem;                       // [C][apb] the block's weights
  float* s_red = s_w + (nch << lg_apb);    // [kWarps][C + 4] each warp's sums: grad_w, then sx, sy, sz, sd
  __shared__ float s_atom[kRows][kWarps];
  __shared__ float s_ex[kWarps][kTab], s_ey[kWarps][kTab];
  __shared__ __align__(16) float2 s_dzez[kWarps][kTab];     // (dz, ez) of each column from the aligned box start
  __shared__ int2 s_planes[kWarps][32];                      // a warp's planes with rows: plane, h - rho
  __shared__ float4 s_rec[kWarps][32], s_rec2[kWarps][32];  // its rows with groups: dx, dy, dx^2, dy^2; th - dx^2, ex ey, gofs, -
  __shared__ int s_voff[kWarps][32];                         // and their first voxel

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int items = a.vp >> lg_apb;
  const int b = blockIdx.x / items;
  const int v0 = (blockIdx.x - b * items) << lg_apb;
  {
    const float* a_row = a.atoms + static_cast<size_t>(b) * 8 * a.vp + v0;
    const float* w_row = a.weights + static_cast<size_t>(b) * nch * a.vp + v0;
#pragma unroll 1
    for (int e = t; e < (kRows + nch) << lg_apb; e += kThreads) {
      const int row = e >> lg_apb, j = e & ((1 << lg_apb) - 1);
      if (row < kRows) {
        s_atom[row][j] = a_row[static_cast<size_t>(row) * a.vp + j];
      } else {
        s_w[e - (kRows << lg_apb)] = w_row[static_cast<size_t>(row - kRows) * a.vp + j];
      }
    }
  }
  __syncthreads();

  const int j = warp >> lg_wpa, part = warp & (wpa - 1);  // this warp's atom, and its share of the atom's rows
  const float x = s_atom[0][j], y = s_atom[1][j], z = s_atom[2][j], th = s_atom[3][j], cf = s_atom[4][j];
  const float res = a.res, inv_res = a.inv_res, hw = a.half_width;
  const float reach = slack_reach(th);
  int dlo, dhi, hlo, hhi, wlo, whi;
  span(x, reach, inv_res, hw, a.dl, dlo, dhi);
  span(y, reach, inv_res, hw, a.dim, hlo, hhi);
  span(z, reach, inv_res, hw, a.dim, wlo, whi);
  const int nd = (dhi >= dlo && hhi >= hlo && whi >= wlo) ? dhi - dlo + 1 : 0;  // planes of the box
  // the factor tables: ex[i], ey[h] over the box, (dz, ez) over its columns
  // from the group-aligned start (kTab entries each; beyond, the same
  // values computed directly)
  const int glo = wlo & ~(kGroup - 1);
  const int ntab_x = min(max(dhi - dlo + 1, 0), kTab), ntab_y = min(max(hhi - hlo + 1, 0), kTab);
  const int ntab = min(max((whi | (kGroup - 1)) + 1 - glo, 0), kTab);
  for (int e = lane; e < max(max(ntab_x, ntab_y), ntab); e += 32) {
    const float dx = __fsub_rn(axis_pos(dlo + e, res, hw), x), dy = __fsub_rn(axis_pos(hlo + e, res, hw), y);
    const float dz = __fsub_rn(axis_pos(glo + e, res, hw), z);
    const float dx2 = __fmul_rn(dx, dx), dy2 = __fmul_rn(dy, dy), dz2 = __fmul_rn(dz, dz);
    s_ex[warp][e] = expf(dx2 * cf);
    s_ey[warp][e] = expf(dy2 * cf);
    s_dzez[warp][e] = make_float2(dz, expf(dz2 * cf));
  }
  __syncwarp();

  const size_t plane = static_cast<size_t>(a.dim) * a.dim;
  const size_t c_stride = static_cast<size_t>(a.dl) * plane;
  const CtT* ct_b = static_cast<const CtT*>(a.ct) + static_cast<size_t>(b) * nch * c_stride;
  float* red = s_red + warp * nred;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sd = 0.0f;

  for (int c0 = 0; c0 < nch; c0 += kCT) {
    const int nc = min(kCT, nch - c0);  // channels of this group
    const CtT* ct_g = ct_b + c0 * c_stride;
    float wk[kCT], gw[kCT];
#pragma unroll
    for (int k = 0; k < kCT; ++k) {
      wk[k] = k < nc ? s_w[((c0 + k) << lg_apb) + j] : 0.0f;
      gw[k] = 0.0f;
    }
    for (int pc = 0; pc < nd; pc += 32) {
      // lane L takes plane dlo + pc + L and its h-span (as deposit_bwd_kernel)
      int hl = 0, hn = 0;
      if (pc + lane < nd) {
        const float dx = __fsub_rn(axis_pos(dlo + pc + lane, res, hw), x);
        const float t_th = __fsub_rn(th, __fmul_rn(dx, dx));
        if (t_th >= 0.0f) {
          int hr;
          span(y, slack_reach(t_th), inv_res, hw, a.dim, hl, hr);
          hl = max(hl, hlo);
          hn = max(min(hr, hhi) - hl + 1, 0);
        }
      }
      int prows;
      const int pincl = warp_scan(hn, lane, prows);
      const bool phas = hn > 0;
      const int prank = __popc(__ballot_sync(kFull, phas) & ((1u << lane) - 1u));
      if (phas) s_planes[warp][prank] = make_int2(pc + lane, hl - (pincl - hn));
      __syncwarp();
      const int share = (prows + wpa - 1) >> lg_wpa;
      const int rend = min(prows, (part + 1) * share);

      for (int q0 = part * share; q0 < rend; q0 += 32) {
        // lane L takes row q0 + L: its plane, terms and w-span, cut into groups
        const int rho = q0 + lane;
        const int2 plane_of = s_planes[warp][owner_rank(phas, pincl, q0, lane)];
        const int pl = plane_of.x, h = rho + plane_of.y;
        const float dx = __fsub_rn(axis_pos(dlo + pl, res, hw), x);
        const float dx2 = __fmul_rn(dx, dx);
        const float t_th = __fsub_rn(th, dx2);
        const float dy = __fsub_rn(axis_pos(h, res, hw), y);
        const float dy2 = __fmul_rn(dy, dy);
        int ng = 0, g0 = 0, voff = 0;
        if (rho < rend && dy2 <= t_th) {
          int lo, hi;
          span(z, slack_reach(__fsub_rn(t_th, dy2)), inv_res, hw, a.dim, lo, hi);
          lo = max(lo, wlo);
          hi = min(hi, whi);
          if (hi >= lo) {
            g0 = lo / kGroup;
            ng = hi / kGroup - g0 + 1;
          }
          voff = ((dlo + pl) * a.dim + h) * a.dim;  // fits an int: checked at launch
        }
        int total;
        const int incl = warp_scan(ng, lane, total);
        const bool has = ng > 0;
        const int slot = __popc(__ballot_sync(kFull, has) & ((1u << lane) - 1u));
        if (has) {
          const unsigned ex_at = static_cast<unsigned>(pl), ey_at = static_cast<unsigned>(h - hlo);
          const float ex = ex_at < static_cast<unsigned>(ntab_x) ? s_ex[warp][ex_at] : expf(dx2 * cf);
          const float ey = ey_at < static_cast<unsigned>(ntab_y) ? s_ey[warp][ey_at] : expf(dy2 * cf);
          s_rec[warp][slot] = make_float4(dx, dy, dx2, dy2);
          s_rec2[warp][slot] = make_float4(t_th, ex * ey, __int_as_float(g0 - (incl - ng)), 0.0f);
          s_voff[warp][slot] = voff;
        }
        __syncwarp();

        // one group a lane, in group order (two in flight measured slower:
        // their registers spill)
        for (int p0 = 0; p0 < total; p0 += 32) {
          const int p = p0 + lane;
          const int src = owner_rank(has, incl, p0, lane);
          if (p < total) {
            const float4 ra = s_rec[warp][src], rb = s_rec2[warp][src];
            const int w0 = (p + __float_as_int(rb.z)) * kGroup;
            const CtT* g_vox = ct_g + s_voff[warp][src] + w0;
            float4 g[kCT];
#pragma unroll
            for (int c = 0; c < kCT; ++c) {
              g[c] = c < nc ? load_ct4(g_vox) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              g_vox += c_stride;
            }
            // (dz, ez) of the group's columns: two 16-byte table reads (the
            // group starts at a multiple of 4 from the table's start), or
            // computed where the box is wider than the table
            float dzs[kGroup], ezs[kGroup];
            const int e0 = w0 - glo;
            if (e0 + kGroup <= ntab) {
              const float4 t01 = *reinterpret_cast<const float4*>(&s_dzez[warp][e0]);
              const float4 t23 = *reinterpret_cast<const float4*>(&s_dzez[warp][e0 + 2]);
              dzs[0] = t01.x, ezs[0] = t01.y, dzs[1] = t01.z, ezs[1] = t01.w;
              dzs[2] = t23.x, ezs[2] = t23.y, dzs[3] = t23.z, ezs[3] = t23.w;
            } else {
#pragma unroll
              for (int i = 0; i < kGroup; ++i) {
                dzs[i] = __fsub_rn(axis_pos(w0 + i, res, hw), z);
                ezs[i] = expf(__fmul_rn(dzs[i], dzs[i]) * cf);
              }
            }
            float tsum = 0.0f;
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const float dz2 = __fmul_rn(dzs[i], dzs[i]);
              const float dyz2 = __fadd_rn(ra.w, dz2);
              const float f = dyz2 <= rb.x ? rb.y * ezs[i] : 0.0f;  // 0 outside the threshold
              float q = 0.0f;
#pragma unroll
              for (int c = 0; c < kCT; ++c) {
                const float gi = i == 0 ? g[c].x : i == 1 ? g[c].y : i == 2 ? g[c].z : g[c].w;
                gw[c] += gi * f;
                q += gi * wk[c];
              }
              const float tq = q * f;
              tsum += tq;
              sz -= tq * dzs[i];
              sd += tq * dyz2;
            }
            sx -= tsum * ra.x;
            sy -= tsum * ra.y;
            sd += tsum * ra.z;
          }
        }
        __syncwarp();  // the records are read; the next rows may overwrite them
      }
      __syncwarp();  // the planes are read; the next planes may overwrite them
    }
    const float total = warp_sums<kCT>(gw, lane);
    const int idx = lane / (32 / kCT);
    if (lane % (32 / kCT) == 0 && c0 + idx < nch) red[c0 + idx] = total;
  }
  {
    float sums[4] = {sx, sy, sz, sd};
    const float total = warp_sums<4>(sums, lane);
    if (lane % 8 == 0) red[nch + lane / 8] = total;
  }
  __syncthreads();

  // one thread per gradient element, atoms fastest: the wpa warps of an atom summed in warp order
#pragma unroll 1
  for (int e = t; e < (nch + 8) << lg_apb; e += kThreads) {
    const int val = e >> lg_apb, jj = e & ((1 << lg_apb) - 1);
    const float* part_sums = s_red + (jj << lg_wpa) * nred;
    if (val < nch) {
      float sum = part_sums[val];
      for (int p = 1; p < wpa; ++p) sum += part_sums[p * nred + val];
      a.grad_w[(static_cast<size_t>(b) * nch + val) * a.vp + v0 + jj] = sum;
    } else {
      const int row = val - nch;
      float g = 0.0f;
      if (row < 3 || row == 4) {
        const int col = nch + (row < 3 ? row : 3);
        float sum = part_sums[col];
        for (int p = 1; p < wpa; ++p) sum += part_sums[p * nred + col];
        g = row < 3 ? 2.0f * s_atom[4][jj] * sum : sum;
      }
      a.grad_rows[(static_cast<size_t>(b) * 8 + row) * a.vp + v0 + jj] = g;
    }
  }
}

using Kernel = void (*)(Args);

// The kernel for a channel group of 1, 4 or 8 (the smallest that holds C,
// or 8 for more).
template <bool kGaussian, typename CtT>
Kernel pick_group(int channels) {
  if (channels <= 1) return deposit_bwd_kernel<kGaussian, 1, CtT>;
  if (channels <= 4) return deposit_bwd_kernel<kGaussian, 4, CtT>;
  return deposit_bwd_kernel<kGaussian, 8, CtT>;
}

template <typename CtT>
Kernel pick(int gaussian, int channels) {
  return gaussian ? pick_group<true, CtT>(channels) : pick_group<false, CtT>(channels);
}

Kernel pick_kernel(int ct_kind, int gaussian, int channels) {
  return ct_kind == 0 ? pick<float>(gaussian, channels) : pick<__nv_bfloat16>(gaussian, channels);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory; above 48 KB
// (about 1,400 channels) this needs cudaFuncSetAttribute.
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 40 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Fills the launch arguments, its blocks and its dynamic shared memory, or
// returns a cudaError_t.
int make_args(Args* a, const void* atoms, const void* weights, const void* ct, void* grad_rows, void* grad_w,
              int batch, int vp, int channels, int dl, int dim, float res, float half_width, int ct_kind, int wpa,
              long long* blocks, size_t* smem) {
  if (batch <= 0 || vp <= 0 || channels <= 0 || dl <= 0 || dim <= 0 || ct_kind < 0 || ct_kind > 1 ||
      (wpa != 1 && wpa != 2 && wpa != 4 && wpa != 8) || wpa > kWarps || vp % (kWarps / wpa) != 0 ||
      static_cast<long long>(dl) * dim * dim > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a->atoms = static_cast<const float*>(atoms);
  a->weights = static_cast<const float*>(weights);
  a->ct = ct;
  a->grad_rows = static_cast<float*>(grad_rows);
  a->grad_w = static_cast<float*>(grad_w);
  a->vp = vp, a->channels = channels, a->dl = dl, a->dim = dim;
  a->lg_wpa = wpa == 1 ? 0 : wpa == 2 ? 1 : wpa == 4 ? 2 : 3;
  a->res = res, a->inv_res = 1.0f / res, a->half_width = half_width;
  *blocks = static_cast<long long>(batch) * (vp / (kWarps / wpa));
  *smem = (static_cast<size_t>(channels) * (kWarps / wpa) + static_cast<size_t>(kWarps) * (channels + 4)) *
          sizeof(float);
  if (*blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

// The threshold-row kernel for a channel group of 1, 4 or 8.
template <typename CtT>
Kernel pick_notrunc(int channels) {
  if (channels <= 1) return deposit_bwd_notrunc_kernel<1, CtT>;
  if (channels <= 4) return deposit_bwd_notrunc_kernel<4, CtT>;
  return deposit_bwd_notrunc_kernel<8, CtT>;
}

Kernel pick_notrunc_kernel(int ct_kind, int channels) {
  return ct_kind == 0 ? pick_notrunc<float>(channels) : pick_notrunc<__nv_bfloat16>(channels);
}

// The threshold-row launch's further conditions: rows of whole groups,
// 16-byte (f32) or 8-byte (bf16) aligned.
int check_notrunc(const void* ct, int dim, int ct_kind) {
  if (dim % kGroup != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(ct) % (ct_kind == 0 ? 16 : 8) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return 0;
}

}  // namespace

extern "C" {

// Threads of a block (molvoxel_torch/ops/deposit.py plans warps per atom with it).
int deposit_bwd_threads() { return kThreads; }

// ct_kind: 0 = float32, 1 = bfloat16.  warps_per_atom: 1, 2, 4 or 8.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
int deposit_bwd(const void* atoms, const void* weights, const void* ct, void* grad_rows, void* grad_w, int batch,
                int vp, int channels, int dl, int dim, float res, float half_width, int gaussian, int ct_kind,
                int warps_per_atom, void* stream) {
  Args a;
  long long blocks = 0;
  size_t smem = 0;
  int rc = make_args(&a, atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                     ct_kind, warps_per_atom, &blocks, &smem);
  if (rc != 0) return rc;
  const Kernel kernel = pick_kernel(ct_kind, gaussian, channels);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                           dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream)));
}

// The blocks of this launch, and how many of them one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
int deposit_bwd_blocks(int batch, int vp, int channels, int gaussian, int ct_kind, int warps_per_atom,
                       long long* blocks, int* resident_per_sm) {
  Args a;
  size_t smem = 0;
  int rc = make_args(&a, nullptr, nullptr, nullptr, nullptr, nullptr, batch, vp, channels, 1, 1, 1.0f, 0.0f, ct_kind,
                     warps_per_atom, blocks, &smem);
  if (rc != 0) return rc;
  const Kernel kernel = pick_kernel(ct_kind, gaussian, channels);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident_per_sm,
                                                                       reinterpret_cast<const void*>(kernel),
                                                                       kThreads, smem));
}

// The threshold-row launch (gaussian only): deposit_bwd_notrunc_kernel,
// with deposit_bwd's arguments; W must be a multiple of 4 and ct 16-byte
// (f32) or 8-byte (bf16) aligned.  Returns the cudaError_t of the launch.
int deposit_bwd_notrunc(const void* atoms, const void* weights, const void* ct, void* grad_rows, void* grad_w,
                        int batch, int vp, int channels, int dl, int dim, float res, float half_width, int ct_kind,
                        int warps_per_atom, void* stream) {
  Args a;
  long long blocks = 0;
  size_t smem = 0;
  int rc = make_args(&a, atoms, weights, ct, grad_rows, grad_w, batch, vp, channels, dl, dim, res, half_width,
                     ct_kind, warps_per_atom, &blocks, &smem);
  if (rc != 0 || (rc = check_notrunc(ct, dim, ct_kind)) != 0) return rc;
  const Kernel kernel = pick_notrunc_kernel(ct_kind, channels);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                           dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream)));
}

// The blocks of the threshold-row launch, and how many of them one SM holds
// at once.  Returns a cudaError_t.
int deposit_bwd_notrunc_blocks(int batch, int vp, int channels, int ct_kind, int warps_per_atom, long long* blocks,
                               int* resident_per_sm) {
  Args a;
  size_t smem = 0;
  int rc = make_args(&a, nullptr, nullptr, nullptr, nullptr, nullptr, batch, vp, channels, 1, 1, 1.0f, 0.0f, ct_kind,
                     warps_per_atom, blocks, &smem);
  if (rc != 0) return rc;
  const Kernel kernel = pick_notrunc_kernel(ct_kind, channels);
  if ((rc = allow_smem(kernel, smem)) != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident_per_sm,
                                                                       reinterpret_cast<const void*>(kernel),
                                                                       kThreads, smem));
}

// Columns a threshold-row lane takes.
int deposit_bwd_notrunc_group() { return kGroup; }

}  // extern "C"
