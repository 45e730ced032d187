// Deposit preparation kernel for Hopper (sm_90a): raw atoms -> the forward
// kernel's inputs (atom rows, masked weights, plane ranges) in one launch.
//
// Replaces no Pallas kernel: it replaces the XLA-side preparation that the
// JAX package fuses into one jitted program before each Pallas launch,
// _run_v5 (molvoxel_tpu/ops/pallas_deposit.py:741-810: weights transpose
// and mask, r^2, the threshold row, coef, the slab shift, the atom rows,
// _plane_ranges_closed at :522) and the batch path's Morton sort and rigid
// transform (molvoxel_tpu/ops/batch.py:105-119, morton_keys at
// pallas_deposit.py:173, _sort_atoms_spatially at :202).  Run eagerly in
// torch the same preparation takes 111 launches for the headline batch and
// 187 for a protein; this kernel does it in one.
//
// Function, per molecule b, bit for bit the plain composition
// in molvoxel_torch/ops/deposit.py (prepare_plain) on the card:
//   p = coords[b, i] - center[b]                       (if centers)
//   q = R p + t, as (x R0 + y R1) + z R2, then + t      (if rot / trans)
//   pad the atom axis to Vp (a multiple of 64) with atoms at FAR, weight 0,
//   radius 1 (channel-wise: r_c), mask off
//   key = Morton key of p (or of q when key_after), 2^30 where masked
//   perm = stable argsort of key (ties by index), or the identity
//   atom j of the output (channel-wise: j = c*Vp + v, virtual atom v of
//   channel c) takes atom perm[j % Vp]:
//     rows[b, :, j] = [q.x - d_offset*res, q.y, q.z, r2_thresh, coef, 0, 0, 0]
//     wt[b, k, j]   = mask ? w[k] : 0         (channel-wise: k == c only)
//     r2 = mask ? r*r : 1;  r2_thresh = r2 (or r2 * notrunc factor);
//     coef = reciprocal(r2) * (-0.5/sigma^2) (gaussian) or 0
//   ranges[b, t, vc] = [d_lo, d_hi) of row tile t (ht rows) and chunk vc,
//     _plane_ranges_closed's closed form, min / max over the chunk's atoms.
// Every float operation is the one torch runs, in its order, with
// __fadd_rn / __fsub_rn / __fmul_rn / __fsqrt_rn / __frcp_rn so that nvcc
// cannot contract a product and a sum into an FMA; a tensor divided by a
// Python float is torch's multiply by the float's f32 reciprocal (inv_res,
// computed on the host in f32); every Python float constant is rounded to
// f32 by a cast, as torch rounds a scalar operand.
//
// What bounds it on an H100 SXM: bytes, and those are few.  The headline
// batch (64 ligands of 64 atoms, C = 4) reads about 0.1 MB and writes about
// 0.2 MB, about 0.1 us at 3.35 TB/s, far under a launch's few microseconds;
// the protein (4,096 atoms) moves about 0.25 MB.  So the time is the
// launch and each block's serial chain, and the design keeps that chain
// short and keeps everything in one launch:
// - Blocks on blockIdx.x only (no grid axis caps the batch: a batch of
//   70,000 molecules exceeds gridDim.y): `split` blocks a molecule, each
//   writing a contiguous share of its 64-atom output chunks and their plane
//   ranges.  A batch takes one block a molecule; a lone molecule splits
//   over up to one block an SM (the wrapper picks), each sorting the whole
//   molecule again (a few microseconds) so that no block waits for another:
//   on an H100, one block for the 4,096-atom protein at 48^3 took 0.081 ms,
//   most of it its 1,536 (tile, chunk) pairs on 32 warps; 64 blocks take
//   0.031 ms, mostly the sort.
// - The sort runs in shared memory: (key << 16 | index) words, so the
//   order of equal keys is the index order (a stable sort), bitonic over
//   the next power of two, one pair a thread a step.  Up to kSortMax atoms
//   fit (64 KB of shared memory); above that the wrapper sorts the keys
//   that deposit_prep_keys writes with torch.argsort and hands the order
//   in (order_in), and this kernel skips its sort.
// - The gather recomputes each atom's placement from the inputs (three
//   loads a thread) instead of staging coordinates; rows and weights are
//   written coalesced, one output atom a thread.
// - Plane ranges: one warp per (row tile, chunk) pair, two atoms a lane,
//   read back from the rows this block just wrote, reduced with shuffles
//   that every lane reaches.
// - No atomics, no host synchronisation; nothing depends on the order in
//   which blocks run, so two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;          // atoms per chunk of the forward kernel
constexpr int kSortMax = 16384;     // atoms a block sorts in shared memory
constexpr int kMaxThreads = 1024;   // threads of the largest block
constexpr int kBits = 5;            // Morton bits per axis
constexpr int kMaskedKey = 1 << 15; // a masked atom's key in the sort word (2^30 in the keys)
constexpr float kFar = 1e3f;        // coordinate of padding atoms

struct Args {
  const float* coords;     // (B, V, 3)
  const float* weights;    // (B, V, C)
  const float* radii;      // (V,) shared, (B, V) batched, or (C,) channel-wise
  const uint8_t* mask;     // (B, V) bool, or null
  const float* centers;    // (B, 3), or null
  const float* table;      // (B, 12): R row-major, then t; or null
  const int* order_in;     // (B, Vp): the sorted order, or null
  float* rows;             // (B, 8, Vo)
  float* wt;               // (B, C, Vo)
  int* ranges;             // (B, nht, Vo / 64, 2)
  int* perm;               // (B, Vp)
  int* keys;               // (B, Vp), deposit_prep_keys only
  int v, vp, c, vo, dl, dim, ht, nht;
  int split, cpb;          // blocks per molecule, and the 64-atom output chunks of each
  int radii_mode;          // 0 shared, 1 batched, 2 channel-wise
  int rot, trans, sort, key_after, gaussian, notrunc;
  float lb, ub, scale, res, inv_res, shift, h_step, coef_k, notrunc_k;
};

// Atom i (< V) of molecule b: its centred coordinates (p) and its placed
// ones (q), in torch's operation order.
__device__ __forceinline__ void place(const Args& a, int b, int i, float3* p, float3* q) {
  const float* src = a.coords + (static_cast<size_t>(b) * a.v + i) * 3;
  float x = src[0], y = src[1], z = src[2];
  if (a.centers != nullptr) {
    const float* cen = a.centers + static_cast<size_t>(b) * 3;
    x = __fsub_rn(x, cen[0]);
    y = __fsub_rn(y, cen[1]);
    z = __fsub_rn(z, cen[2]);
  }
  *p = make_float3(x, y, z);
  if (a.rot) {
    const float* tb = a.table + static_cast<size_t>(b) * 12;
    const float qx = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[0]), __fmul_rn(y, tb[1])), __fmul_rn(z, tb[2]));
    const float qy = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[3]), __fmul_rn(y, tb[4])), __fmul_rn(z, tb[5]));
    const float qz = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[6]), __fmul_rn(y, tb[7])), __fmul_rn(z, tb[8]));
    x = qx, y = qy, z = qz;
  }
  if (a.trans) {
    const float* tb = a.table + static_cast<size_t>(b) * 12;
    x = __fadd_rn(x, tb[9]);
    y = __fadd_rn(y, tb[10]);
    z = __fadd_rn(z, tb[11]);
  }
  *q = make_float3(x, y, z);
}

__device__ __forceinline__ bool live_atom(const Args& a, int b, int i) {
  if (a.mask == nullptr) return true;
  return i < a.v && a.mask[static_cast<size_t>(b) * a.v + i] != 0;
}

__device__ __forceinline__ int morton_cell(const Args& a, float p) {
  const float s = __fmul_rn(__fsub_rn(p, a.lb), a.scale);
  return static_cast<int>(fminf(fmaxf(s, 0.0f), static_cast<float>((1 << kBits) - 1)));  // truncates
}

// The Morton key of padded atom i (x bits most significant), or -1 for a
// masked atom (its key is 2^30).
__device__ int morton_key(const Args& a, int b, int i) {
  if (!live_atom(a, b, i)) return -1;
  float3 p = make_float3(kFar, kFar, kFar), q = p;
  if (i < a.v) place(a, b, i, &p, &q);
  const float3 s = a.key_after ? q : p;
  const int cx = morton_cell(a, s.x), cy = morton_cell(a, s.y), cz = morton_cell(a, s.z);
  int key = 0;
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    key |= ((cx >> k) & 1) << (3 * k + 2);
    key |= ((cy >> k) & 1) << (3 * k + 1);
    key |= ((cz >> k) & 1) << (3 * k);
  }
  return key;
}

__device__ __forceinline__ float radius(const Args& a, int b, int src, int channel) {
  if (a.radii_mode == 2) return a.radii[channel];
  if (src >= a.v) return 1.0f;
  return a.radii_mode == 1 ? a.radii[static_cast<size_t>(b) * a.v + src] : a.radii[src];
}

// Sorts the block's n2 words (a power of two) ascending: bitonic, one
// compare-exchange per thread per pass.
__device__ void bitonic_sort(uint32_t* s, int n2) {
  const int half = n2 >> 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const uint32_t x = s[i], y = s[l];
        if ((x > y) == ((i & k) == 0)) {
          s[i] = y;
          s[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) deposit_prep_kernel(const Args a) {
  extern __shared__ uint32_t words[];
  const int b = blockIdx.x / a.split;
  const int part = blockIdx.x % a.split;  // this block's output chunks: [part * cpb, (part + 1) * cpb)
  const int nvc = a.vo / kChunk;
  const int vc0 = part * a.cpb, vc1 = min(vc0 + a.cpb, nvc);
  const bool sorted_here = a.sort && a.order_in == nullptr;
  if (sorted_here) {
    int n2 = 1;
    while (n2 < a.vp) n2 <<= 1;
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      uint32_t word = 0xffffffffu;
      if (i < a.vp) {
        const int key = morton_key(a, b, i);
        word = (static_cast<uint32_t>(key < 0 ? kMaskedKey : key) << 16) | static_cast<uint32_t>(i);
      }
      words[i] = word;
    }
    __syncthreads();
    bitonic_sort(words, n2);
  }

  // the gather: one output atom of this block's chunks a thread
  const size_t vo = a.vo;
  float* rows = a.rows + static_cast<size_t>(b) * 8 * vo;
  float* wt = a.wt + static_cast<size_t>(b) * a.c * vo;
  const float* wsrc = a.weights + static_cast<size_t>(b) * a.v * a.c;
  for (int j = vc0 * kChunk + threadIdx.x; j < vc1 * kChunk; j += blockDim.x) {
    const int v = j % a.vp;
    const int channel = j / a.vp;  // the virtual atom's channel (channel-wise); 0 otherwise
    int src = v;
    if (sorted_here) {
      src = static_cast<int>(words[v] & 0xffffu);
    } else if (a.order_in != nullptr) {
      src = a.order_in[static_cast<size_t>(b) * a.vp + v];
    }
    if (j < a.vp) a.perm[static_cast<size_t>(b) * a.vp + j] = src;
    float3 p = make_float3(kFar, kFar, kFar), q = p;
    if (src < a.v) place(a, b, src, &p, &q);
    const bool live = live_atom(a, b, src);
    const float r = radius(a, b, src, channel);
    const float r2 = live ? __fmul_rn(r, r) : 1.0f;
    rows[0 * vo + j] = __fsub_rn(q.x, a.shift);
    rows[1 * vo + j] = q.y;
    rows[2 * vo + j] = q.z;
    rows[3 * vo + j] = a.notrunc ? __fmul_rn(r2, a.notrunc_k) : r2;
    rows[4 * vo + j] = a.gaussian ? __fmul_rn(__frcp_rn(r2), a.coef_k) : 0.0f;
    rows[5 * vo + j] = 0.0f;
    rows[6 * vo + j] = 0.0f;
    rows[7 * vo + j] = 0.0f;
    const bool has_w = live && src < a.v;
    for (int k = 0; k < a.c; ++k) {
      const bool mine = a.radii_mode != 2 || k == channel;
      wt[static_cast<size_t>(k) * vo + j] = has_w && mine ? wsrc[static_cast<size_t>(src) * a.c + k] : 0.0f;
    }
  }
  __syncthreads();  // the rows above are read back below

  // plane ranges: one warp per (row tile, chunk) pair of this block's chunks
  const int lane = threadIdx.x & 31;
  const int mine = vc1 - vc0;
  const int npairs = a.nht * mine;
  const float one_plus = static_cast<float>(1.000002);
  const float pad = static_cast<float>(1e-6);
  int* out = a.ranges + static_cast<size_t>(b) * a.nht * nvc * 2;
  for (int pair = threadIdx.x >> 5; pair < npairs; pair += blockDim.x >> 5) {
    const int t = pair / mine, vc = vc0 + pair % mine;
    const float h_lo = __fadd_rn(__fmul_rn(static_cast<float>(t * a.ht), a.res), a.lb);
    const float h_hi = __fadd_rn(h_lo, a.h_step);
    int lo = a.dl, hi = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = vc * kChunk + half * 32 + lane;
      const float x = rows[0 * vo + j], y = rows[1 * vo + j], z = rows[2 * vo + j], r2 = rows[3 * vo + j];
      const float dy = fmaxf(fmaxf(__fsub_rn(h_lo, y), __fsub_rn(y, h_hi)), 0.0f);
      const float dz = fmaxf(fmaxf(__fsub_rn(a.lb, z), __fsub_rn(z, a.ub)), 0.0f);
      const float s2 = __fsub_rn(r2, __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dz, dz)));
      const float s = __fadd_rn(__fmul_rn(__fsqrt_rn(fmaxf(s2, 0.0f)), one_plus), pad);
      float flo = ceilf(__fmul_rn(__fsub_rn(__fsub_rn(x, s), a.lb), a.inv_res));
      float fhi = __fadd_rn(floorf(__fmul_rn(__fsub_rn(__fadd_rn(x, s), a.lb), a.inv_res)), 1.0f);
      flo = fminf(fmaxf(flo, 0.0f), static_cast<float>(a.dl));
      fhi = fminf(fmaxf(fhi, 0.0f), static_cast<float>(a.dl));
      const bool empty = s2 < 0.0f;
      lo = min(lo, empty ? a.dl : static_cast<int>(flo));
      hi = max(hi, empty ? 0 : static_cast<int>(fhi));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      out[(t * nvc + vc) * 2 + 0] = lo;
      out[(t * nvc + vc) * 2 + 1] = max(hi, lo);  // all-empty chunks become d_hi == d_lo
    }
  }
}

// The Morton keys alone (B, Vp), for molecules above kSortMax atoms: the
// wrapper sorts them with torch.argsort and launches deposit_prep_kernel
// with the order.
__global__ void __launch_bounds__(256) deposit_prep_keys_kernel(const Args a) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < a.vp; i += blockDim.x) {
    const int key = morton_key(a, b, i);
    a.keys[static_cast<size_t>(b) * a.vp + i] = key < 0 ? (1 << 30) : key;
  }
}

int check_args(const Args& a, int batch, int threads) {
  if (a.split < 1 || a.cpb < 1 || static_cast<long long>(a.split) * a.cpb * kChunk < a.vo ||
      static_cast<long long>(batch) * a.split > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || a.v <= 0 || a.vp < a.v || a.vp % kChunk != 0 || a.c <= 0 || a.vo % kChunk != 0 ||
      a.vo != (a.radii_mode == 2 ? a.c * a.vp : a.vp) || a.dl <= 0 || a.dim <= 0 || a.ht < 1 || a.nht < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || a.vp > 65536 || a.radii_mode < 0 ||
      a.radii_mode > 2 || ((a.rot || a.trans) && a.table == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int sort_words(const Args& a) {
  if (!a.sort || a.order_in != nullptr) return 0;
  int n2 = 1;
  while (n2 < a.vp) n2 <<= 1;
  return n2;
}

}  // namespace

extern "C" {

// Constants the Python side plans with (molvoxel_torch/ops/deposit.py).
int deposit_prep_chunk() { return kChunk; }
int deposit_prep_sort_max() { return kSortMax; }
int deposit_prep_max_threads() { return kMaxThreads; }

// One launch of B x split blocks of `threads`, block s of a molecule
// writing its output chunks [s * cpb, (s + 1) * cpb).  sort: Morton-sort the
// atoms in shared memory (at most kSortMax of them) unless order_in gives
// the order.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
int deposit_prep(const void* coords, const void* weights, const void* radii, const void* mask, const void* centers,
                 const void* table, const void* order_in, void* rows, void* wt, void* ranges, void* perm, int batch,
                 int v, int vp, int c, int vo, int dl, int dim, int ht, int nht, int split, int cpb, int radii_mode,
                 int rot, int trans, int sort, int key_after, int gaussian, int notrunc, float lb, float ub,
                 float scale, float res, float inv_res, float shift, float h_step, float coef_k, float notrunc_k,
                 int threads, void* stream) {
  Args a{static_cast<const float*>(coords), static_cast<const float*>(weights), static_cast<const float*>(radii),
         static_cast<const uint8_t*>(mask), static_cast<const float*>(centers), static_cast<const float*>(table),
         static_cast<const int*>(order_in), static_cast<float*>(rows), static_cast<float*>(wt),
         static_cast<int*>(ranges), static_cast<int*>(perm), nullptr,
         v, vp, c, vo, dl, dim, ht, nht, split, cpb, radii_mode, rot, trans, sort, key_after, gaussian, notrunc,
         lb, ub, scale, res, inv_res, shift, h_step, coef_k, notrunc_k};
  int rc = check_args(a, batch, threads);
  if (rc != 0) return rc;
  const int n2 = sort_words(a);
  if (n2 > kSortMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n2) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // above the default, opt in (for the current device)
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(deposit_prep_kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(deposit_prep_kernel),
                                           dim3(static_cast<unsigned>(batch * split)), dim3(threads), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}

// The Morton keys (B, Vp) int32 of the atoms as deposit_prep would sort
// them (masked atoms 2^30).  Returns the cudaError_t of the launch.
int deposit_prep_keys(const void* coords, const void* mask, const void* centers, const void* table, void* keys,
                      int batch, int v, int vp, int rot, int trans, int key_after, float lb, float scale,
                      void* stream) {
  Args a{};
  a.coords = static_cast<const float*>(coords);
  a.mask = static_cast<const uint8_t*>(mask);
  a.centers = static_cast<const float*>(centers);
  a.table = static_cast<const float*>(table);
  a.keys = static_cast<int*>(keys);
  a.v = v, a.vp = vp, a.rot = rot, a.trans = trans, a.key_after = key_after, a.lb = lb, a.scale = scale;
  if (batch <= 0 || v <= 0 || vp < v || ((rot || trans) && table == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(deposit_prep_keys_kernel),
                                           dim3(static_cast<unsigned>(batch)), dim3(256), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
