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
// launch and each block's serial chain of dependent loads, barriers and
// remote stores, and the design keeps that chain short and everything in
// one launch, at every size up to 65,536 atoms a molecule:
// - Blocks on blockIdx.x only (no grid axis caps the batch: a batch of
//   70,000 molecules exceeds gridDim.y): `split` blocks a molecule, each
//   writing a contiguous share of its 64-atom output chunks and their plane
//   ranges.  A molecule that is not sorted splits over up to one block an
//   SM (the wrapper picks).
// - A molecule that is sorted is one thread-block cluster of its `split`
//   blocks (at most 8, or 16 where the card runs such clusters: the wrapper
//   asks deposit_prep_setup), launched with cudaLaunchKernelEx, and the
//   cluster sorts it once: block r keys the atoms [r*seg, (r+1)*seg) as
//   32-bit words, the 16-bit key (the 15-bit Morton key, bit 15 set where
//   masked) above the 16-bit index, so the words are unique and their order
//   is the stable order of the keys; every block receives the sorted words
//   of the ranks of its own output atoms (oseg of them) in its shared
//   memory, over distributed shared memory.  No block sorts another block's
//   share, and no block of a molecule sorts it again.
//   * Shares of up to kSearchShare atoms (the protein's 16 blocks of 256;
//     search_sort): each block ranks its words within its share by
//     counting, stores the sorted share into every block of the cluster
//     (16-byte remote stores), and after one cluster barrier ranks each of
//     its words in the molecule by a binary search in every share; each
//     word goes to the block that owns its rank, and a second barrier ends
//     the sort.
//   * Larger shares (radix_sort, up to 8,192 atoms a block): a stable LSD
//     radix sort in two 8-bit digit passes.  Each warp ranks its words with
//     __match_any_sync and a running count of each digit; a block scan over
//     its warps gives the block's 256 counts, which every block stores into
//     every other; after a cluster barrier each word goes straight to the
//     block that owns its rank (block order is index order, so the sort is
//     stable by construction), and a barrier ends the pass.
//   A block stores into another only after the whole cluster has started
//   (a cluster barrier arrived at on entry, waited on before the first
//   remote store), and where a block reads another's words after the sort
//   (channel-wise copies) a last cluster barrier keeps them alive.
// - The gather: one output atom a thread; every load of an atom waits on
//   its index alone (a molecule's center and transform are loaded once);
//   rows and weights are written coalesced, and x, y, dz^2 and r2 of each
//   output atom are kept in shared memory (kStage atoms at a time).
// - Plane ranges: one warp per (row tile, chunk) pair, two atoms a lane,
//   read from that shared copy, reduced with redux.sync that every lane
//   reaches.  A lane whose atom misses the tile (s2 < 0) skips the square
//   root: its bounds would be (Dl, 0), which change neither side.
// - No atomics on the outputs, no host synchronisation; nothing depends on
//   the order in which blocks run, so two launches give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;          // atoms per chunk of the forward kernel
constexpr int kMaxThreads = 1024;   // threads of the largest block
constexpr int kMaxCluster = 16;     // blocks of the largest cluster (8 is portable)
constexpr int kSearchShare = 512;   // atoms a block sorts when it ranks them by search (a power of two)
constexpr int kItems = 8;           // sort words a thread holds in registers in the radix sort
constexpr int kSortThreads = 256;   // threads of a sorting block, at least: one a digit in the radix sort's scan
constexpr int kStage = 2048;        // output atoms whose x, y, dz^2, r2 a block keeps in shared memory at once
constexpr int kDigits = 256;        // bins of an 8-bit digit
constexpr int kBits = 5;            // Morton bits per axis
constexpr int kMaskedKey = 1 << 15; // a masked atom's key in the sort word (2^30 in the keys)
constexpr float kFar = 1e3f;        // coordinate of padding atoms

// Dynamic shared memory of a block (every block of a launch asks the
// same): the staged atoms of up to kStage output atoms; a block of a sorting cluster also the words of the `oseg` ranks it
// receives, and ahead of the staged atoms (which reuse it) a scratch for
// the sort.  Shares of at most kSearchShare atoms (search_sort): every
// block's sorted share (vp), its own words, their ranks in the share and
// in the molecule (3 x seg).  Larger (radix_sort): the words (seg), every
// block's digit counts (split x 256), the digit offsets (256) and each
// warp's counts (256 a warp).
constexpr size_t smem_bytes(int sort, int vp, int seg, int oseg, int split, int threads, int cpb) {
  const size_t chunks = cpb < kStage / kChunk ? cpb : kStage / kChunk;
  const size_t stage = chunks * kChunk * sizeof(float4);
  if (!sort) return stage;
  const bool search = seg <= kSearchShare;
  const size_t scratch = search ? static_cast<size_t>(vp + 3 * seg) * sizeof(uint32_t)
                                : static_cast<size_t>(split + 1 + threads / 32) * kDigits * sizeof(int);
  const size_t words = static_cast<size_t>(search || oseg > seg ? oseg : seg) * sizeof(uint32_t);
  return words + (scratch > stage ? scratch : stage);
}
constexpr size_t kSmemMax = 226 * 1024;  // dynamic shared memory a block may ask for (an H100's 227 KB less static)

struct Args {
  const float* coords;     // (B, V, 3)
  const float* weights;    // (B, V, C)
  const float* radii;      // (V,) shared, (B, V) batched, or (C,) channel-wise
  const uint8_t* mask;     // (B, V) bool, or null
  const float* centers;    // (B, 3), or null
  const float* table;      // (B, 12): R row-major, then t; or null
  float* rows;             // (B, 8, Vo)
  float* wt;               // (B, C, Vo)
  int* ranges;             // (B, nht, Vo / 64, 2)
  int* perm;               // (B, Vp)
  int v, vp, c, vo, dl, dim, ht, nht;
  int split, cpb;          // blocks per molecule (the cluster when sorting), and the 64-atom output chunks of each
  int seg;                 // atoms a block of a sorting cluster sorts: block r the atoms [r*seg, (r+1)*seg)
  int oseg;                // sorted ranks a block receives: block r holds ranks [r*oseg, (r+1)*oseg)
  int radii_mode;          // 0 shared, 1 batched, 2 channel-wise
  int rot, trans, sort, key_after, gaussian, notrunc;
  float lb, ub, scale, res, inv_res, shift, h_step, coef_k, notrunc_k;
};

// A molecule's center and rigid transform, held in registers: loaded once
// a thread, so that an atom's placement waits on its own coordinates only.
struct Pose {
  float cen[3];
  float tb[12];  // R row-major, then t
};

__device__ __forceinline__ Pose load_pose(const Args& a, int b) {
  Pose m{};
  if (a.centers != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) m.cen[k] = __ldg(a.centers + static_cast<size_t>(b) * 3 + k);
  }
  if (a.table != nullptr) {
#pragma unroll
    for (int k = 0; k < 12; ++k) m.tb[k] = __ldg(a.table + static_cast<size_t>(b) * 12 + k);
  }
  return m;
}

// Padded atom i of molecule b: its centred coordinates (p) and its placed
// ones (q), in torch's operation order; FAR for a padding atom (i >= V).
// The loads do not wait on i < V (a padding atom reads atom V - 1).
__device__ __forceinline__ void place(const Args& a, const Pose& m, int b, int i, float3* p, float3* q) {
  const float* src = a.coords + (static_cast<size_t>(b) * a.v + min(i, a.v - 1)) * 3;
  float x = __ldg(src), y = __ldg(src + 1), z = __ldg(src + 2);
  if (a.centers != nullptr) {
    x = __fsub_rn(x, m.cen[0]);
    y = __fsub_rn(y, m.cen[1]);
    z = __fsub_rn(z, m.cen[2]);
  }
  *p = make_float3(x, y, z);
  if (a.rot) {
    const float* tb = m.tb;
    const float qx = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[0]), __fmul_rn(y, tb[1])), __fmul_rn(z, tb[2]));
    const float qy = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[3]), __fmul_rn(y, tb[4])), __fmul_rn(z, tb[5]));
    const float qz = __fadd_rn(__fadd_rn(__fmul_rn(x, tb[6]), __fmul_rn(y, tb[7])), __fmul_rn(z, tb[8]));
    x = qx, y = qy, z = qz;
  }
  if (a.trans) {
    x = __fadd_rn(x, m.tb[9]);
    y = __fadd_rn(y, m.tb[10]);
    z = __fadd_rn(z, m.tb[11]);
  }
  *q = make_float3(x, y, z);
  if (i >= a.v) *p = *q = make_float3(kFar, kFar, kFar);
}

__device__ __forceinline__ bool live_atom(const Args& a, int b, int i) {
  if (a.mask == nullptr) return true;
  const bool m = __ldg(a.mask + static_cast<size_t>(b) * a.v + min(i, a.v - 1)) != 0;
  return i < a.v && m;
}

__device__ __forceinline__ int morton_cell(const Args& a, float p) {
  const float s = __fmul_rn(__fsub_rn(p, a.lb), a.scale);
  return static_cast<int>(fminf(fmaxf(s, 0.0f), static_cast<float>((1 << kBits) - 1)));  // truncates
}

// The sort word of padded atom i: its 16-bit key (the Morton key, x bits
// most significant, or kMaskedKey for a masked atom) above its index.
__device__ __forceinline__ uint32_t sort_word(const Args& a, const Pose& m, int b, int i) {
  float3 p, q;
  place(a, m, b, i, &p, &q);
  const bool live = live_atom(a, b, i);
  const float3 s = a.key_after ? q : p;
  const int cx = morton_cell(a, s.x), cy = morton_cell(a, s.y), cz = morton_cell(a, s.z);
  int key = 0;
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    key |= ((cx >> k) & 1) << (3 * k + 2);
    key |= ((cy >> k) & 1) << (3 * k + 1);
    key |= ((cz >> k) & 1) << (3 * k);
  }
  return (static_cast<uint32_t>(live ? key : kMaskedKey) << 16) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ float radius(const Args& a, int b, int src, int channel) {
  if (a.radii_mode == 2) return __ldg(a.radii + channel);
  const float r = __ldg(a.radii + (a.radii_mode == 1 ? static_cast<size_t>(b) * a.v : 0) + min(src, a.v - 1));
  return src < a.v ? r : 1.0f;
}

// The shared memory of a block of a cluster that sorts by digits (see smem_bytes).
struct SortSmem {
  uint32_t* words;   // the block's words after the low digit's pass, then its sorted ranks
  int* counts;       // [split][256] every block's digit counts, each block storing its own into every one
  int* base;         // [256] the first rank of each digit in this block
  int* hist;         // [warps][256] each warp's running digit counts, then their prefix over warps
};

// Ranks each of the block's words among the earlier words of its digit
// in its warp (order[k]), then turns the warps' counts into their
// exclusive prefix over warps; returns the block's count of digit d for
// thread d < 256 (0 for the rest).
__device__ __forceinline__ int rank_words(const uint32_t (&word)[kItems], int (&order)[kItems], int* hist, int items,
                                          int swarps, int len, int shift) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below_me = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < swarps * kDigits; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  int* mine = hist + warp * kDigits;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (warp < swarps && k < items) {  // the same for every lane of the warp
      const int p = (warp * items + k) * 32 + lane;
      const bool valid = p < len;
      const int digit = static_cast<int>((word[k] >> shift) & 0xffu);
      const int match = valid ? digit : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, match);
      const int before = __popc(peers & below_me);
      const int prior = valid ? mine[digit] : 0;
      __syncwarp();
      if (valid && before == __popc(peers) - 1) mine[digit] = prior + __popc(peers);  // the last of its peers
      __syncwarp();
      order[k] = prior + before;
    }
  }
  __syncthreads();
  int sum = 0;
  if (threadIdx.x < kDigits) {
    const int d = threadIdx.x;
#pragma unroll 8
    for (int w = 0; w < swarps; ++w) {
      const int n = hist[w * kDigits + d];
      hist[w * kDigits + d] = sum;
      sum += n;
    }
  }
  return sum;
}

// base[d] for thread d < 256, from this digit's total over the cluster and
// its count in the blocks before this one: the cluster's words of lower
// digits plus `earlier`.  Every thread calls it; it ends in a barrier.
__device__ __forceinline__ void digit_base(int* base, int total, int earlier) {
  __shared__ int warp_total[kDigits / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kDigits) {  // whole warps: blockDim.x >= kSortThreads
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_total[warp] = incl;
    base[threadIdx.x] = incl - total + earlier;
  }
  __syncthreads();
  if (threadIdx.x < kDigits) {
    int lower = 0;
    for (int w = 0; w < warp; ++w) lower += warp_total[w];
    base[threadIdx.x] += lower;
  }
  __syncthreads();
}

// A block of a sorting cluster may store into another's shared memory
// only once that block has started: every block arrives at the start and
// waits before its first remote store.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }

// The words of `list` (n ascending, n < 2 kSearchShare) below w: a binary
// search of a fixed number of steps, so that the searches of one thread
// interleave and the lanes of a warp do not diverge.
__device__ __forceinline__ int lower_bound(const uint32_t* list, int n, uint32_t w) {
  int pos = 0;
#pragma unroll
  for (int step = kSearchShare; step > 0; step >>= 1) {
    const int at = pos + step;
    pos = at <= n && list[at - 1] < w ? at : pos;
  }
  return pos;
}

// Sorts molecule b (each block's share at most kSearchShare atoms) over
// its cluster: afterwards block r's `words` hold the sorted words of ranks
// [r*oseg, (r+1)*oseg).  Every thread of every block of the cluster calls
// it.  Block r keys its share, the atoms [r*seg, (r+1)*seg), and ranks
// each word in it by counting the words below it; it stores its share,
// sorted, into every block of the cluster.  After one cluster barrier it
// ranks each of its words against every share: the words are unique (the
// index is in their low bits), so a word's rank in the molecule is the
// number of words below it, the sum of a binary search in each share, and
// that order is the stable sort of the keys.  Each word goes to the block
// that owns its rank; a second cluster barrier ends the sort.  `parts`
// threads share each word's count and its searches.
__device__ void search_sort(const Args& a, int b, int rank, uint32_t* words, uint32_t* scratch) {
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t* all = scratch;                               // [vp] every share, sorted, at r * seg
  uint32_t* raw = all + a.vp;                            // [seg] this block's words in index order
  int* in_share = reinterpret_cast<int*>(raw + a.seg);  // [seg] each word's rank in the share
  int* below = in_share + a.seg;                         // [seg] ... in the molecule
  const int len = max(0, min(a.seg, a.vp - rank * a.seg));
  const int parts = len > 0 ? max(1, static_cast<int>(blockDim.x) / len) : 1;
  cluster_arrive();
  {
    const Pose m = load_pose(a, b);
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      raw[i] = sort_word(a, m, b, rank * a.seg + i);
      in_share[i] = 0;
      below[i] = 0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len * parts; i += blockDim.x) {
    const int k = i % len, part = i / len;
    const uint32_t w = raw[k];
    int n = 0;
    for (int j = part * len / parts; j < (part + 1) * len / parts; ++j) n += raw[j] < w ? 1 : 0;
    atomicAdd(in_share + k, n);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += blockDim.x) all[rank * a.seg + in_share[k]] = raw[k];
  __syncthreads();
  cluster_wait();
  // the sorted share into every other block, 16 bytes a store
  const uint4* mine = reinterpret_cast<const uint4*>(all + rank * a.seg);
  const int vecs = len / 4;  // len is a multiple of 32
  for (int i = threadIdx.x; i < vecs * a.split; i += blockDim.x) {
    const int r = i / vecs, k = i - r * vecs;
    if (r != rank) reinterpret_cast<uint4*>(cluster.map_shared_rank(all, r) + rank * a.seg)[k] = mine[k];
  }
  cluster.sync();  // every share is in every block
  for (int i = threadIdx.x; i < len * parts; i += blockDim.x) {
    const int k = i % len, part = i / len;
    const uint32_t w = raw[k];
    int n = 0;
#pragma unroll 4
    for (int r = part; r < a.split; r += parts) n += lower_bound(all + r * a.seg, min(a.seg, a.vp - r * a.seg), w);
    atomicAdd(below + k, n);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const int dest = below[k];
    const int owner = dest / a.oseg;
    uint32_t* to = owner == rank ? words : cluster.map_shared_rank(words, owner);
    to[dest - owner * a.oseg] = raw[k];
  }
  cluster.sync();  // every sorted word is in place
}

// Sorts molecule b (shares above kSearchShare atoms) over its cluster by digits:
// afterwards block r's `sm.words` hold the sorted words of ranks
// [r*oseg, (r+1)*oseg).  Every thread of every block of the cluster calls
// it.  Block r keys the atoms [r*seg, (r+1)*seg) in index order, held by
// its first `swarps` warps, `items` a lane (word k of a lane is the block's
// word (warp * items + k) * 32 + lane, so a warp's words run in index
// order, round by round).  A stable LSD radix sort in two passes of an
// 8-bit digit: each ranks the block's words, stores the block's digit
// counts into every block, and after a cluster barrier stores each word
// into the block that owns its rank (block order is index order, so the
// sort is stable by construction); a cluster barrier ends the pass.
__device__ void radix_sort(const Args& a, int b, int rank, const SortSmem& sm) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = (a.seg + blockDim.x - 1) / blockDim.x;
  const int swarps = (a.seg + 32 * items - 1) / (32 * items);
  const int len = max(0, min(a.seg, a.vp - rank * a.seg));
  uint32_t word[kItems];
  int order[kItems];
  cluster_arrive();
  {
    const Pose m = load_pose(a, b);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = (warp * items + k) * 32 + lane;
      word[k] = k < items && p < len ? sort_word(a, m, b, rank * a.seg + p) : 0xffffffffu;
    }
  }
  for (int pass = 0; pass < 2; ++pass) {
    const int shift = 16 + 8 * pass;
    const int seg = pass == 0 ? a.seg : a.oseg;  // the owners of the ranks this pass stores to
    if (pass == 1) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int p = (warp * items + k) * 32 + lane;
        word[k] = k < items && p < len ? sm.words[p] : 0xffffffffu;
      }
    }
    int n = rank_words(word, order, sm.hist, items, swarps, len, shift);
    if (pass == 0) cluster_wait();
    if (threadIdx.x < kDigits) {
      for (int r = 0; r < a.split; ++r) cluster.map_shared_rank(sm.counts, r)[rank * kDigits + threadIdx.x] = n;
    }
    cluster.sync();  // every block's counts are in place, and its words are in registers
    int total = 0, earlier = 0;
    if (threadIdx.x < kDigits) {
#pragma unroll 4
      for (int r = 0; r < a.split; ++r) {
        n = sm.counts[r * kDigits + threadIdx.x];
        total += n;
        earlier += r < rank ? n : 0;
      }
    }
    digit_base(sm.base, total, earlier);
    // the scatter
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = (warp * items + k) * 32 + lane;
      if (k < items && p < len) {
        const int digit = static_cast<int>((word[k] >> shift) & 0xffu);
        const int dest = sm.base[digit] + sm.hist[warp * kDigits + digit] + order[k];
        const int owner = dest / seg;
        uint32_t* to = owner == rank ? sm.words : cluster.map_shared_rank(sm.words, owner);
        to[dest - owner * seg] = word[k];
      }
    }
    cluster.sync();  // every word of this pass is in place, and the counts of this pass are read
  }
}

__global__ void __launch_bounds__(kMaxThreads) deposit_prep_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int b = blockIdx.x / a.split;
  const int part = blockIdx.x % a.split;  // the block's rank in its cluster when sorting
  const int nvc = a.vo / kChunk;
  const int vc0 = min(part * a.cpb, nvc), vc1 = min(vc0 + a.cpb, nvc);  // this block's output chunks
  const bool sorted_here = a.sort != 0;
  // output atoms whose rank another block owns: channel-wise copies, or ranks not laid out as the outputs
  const bool remote_ranks = a.vo != a.vp || a.oseg != a.cpb * kChunk;
  const uint32_t* words = smem;
  float4* stage = reinterpret_cast<float4*>(smem);
  if (sorted_here) {
    const bool search = a.seg <= kSearchShare;  // the same for every block of the launch
    uint32_t* scratch = smem + (search ? a.oseg : max(a.seg, a.oseg));
    if (search) {
      search_sort(a, b, part, smem, scratch);
    } else {
      SortSmem sm;
      sm.words = smem;
      sm.counts = reinterpret_cast<int*>(scratch);
      sm.base = sm.counts + a.split * kDigits;
      sm.hist = sm.base + kDigits;
      radix_sort(a, b, part, sm);
    }
    stage = reinterpret_cast<float4*>(scratch);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const Pose pose = load_pose(a, b);

  const size_t vo = a.vo;
  float* rows = a.rows + static_cast<size_t>(b) * 8 * vo;
  float* wt = a.wt + static_cast<size_t>(b) * a.c * vo;
  const float* wsrc = a.weights + static_cast<size_t>(b) * a.v * a.c;
  int* out = a.ranges + static_cast<size_t>(b) * a.nht * nvc * 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float one_plus = static_cast<float>(1.000002);
  const float pad = static_cast<float>(1e-6);
  for (int s0 = vc0; s0 < vc1; s0 += kStage / kChunk) {
    const int s1 = min(s0 + kStage / kChunk, vc1);
    const int mine = s1 - s0;
    // the gather: one output atom of these chunks a thread
    for (int j = s0 * kChunk + threadIdx.x; j < s1 * kChunk; j += blockDim.x) {
      const int v = j % a.vp;
      const int channel = j / a.vp;  // the virtual atom's channel (channel-wise); 0 otherwise
      int src = v;
      if (sorted_here) {
        const int owner = v / a.oseg;
        const uint32_t* from = owner == part ? words : cluster.map_shared_rank(words, owner);
        src = static_cast<int>(from[v - owner * a.oseg] & 0xffffu);
      }
      // every load waits on src only
      float3 p, q;
      place(a, pose, b, src, &p, &q);
      const bool live = live_atom(a, b, src);
      const float r = radius(a, b, src, channel);
      const float* wrow = wsrc + static_cast<size_t>(min(src, a.v - 1)) * a.c;
      float w8[8];  // the first eight channels' weights
#pragma unroll
      for (int k = 0; k < 8; ++k) w8[k] = k < a.c && (a.radii_mode != 2 || k == channel) ? __ldg(wrow + k) : 0.0f;
      const bool has_w = live && src < a.v;
      if (j < a.vp) a.perm[static_cast<size_t>(b) * a.vp + j] = src;
      const float r2 = live ? __fmul_rn(r, r) : 1.0f;
      const float x = __fsub_rn(q.x, a.shift);
      const float r2_th = a.notrunc ? __fmul_rn(r2, a.notrunc_k) : r2;
      rows[0 * vo + j] = x;
      rows[1 * vo + j] = q.y;
      rows[2 * vo + j] = q.z;
      rows[3 * vo + j] = r2_th;
      rows[4 * vo + j] = a.gaussian ? __fmul_rn(__frcp_rn(r2), a.coef_k) : 0.0f;
      rows[5 * vo + j] = 0.0f;
      rows[6 * vo + j] = 0.0f;
      rows[7 * vo + j] = 0.0f;
      const float dz = fmaxf(fmaxf(__fsub_rn(a.lb, q.z), __fsub_rn(q.z, a.ub)), 0.0f);
      stage[j - s0 * kChunk] = make_float4(x, q.y, __fmul_rn(dz, dz), r2_th);  // what the plane ranges read
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < a.c) wt[static_cast<size_t>(k) * vo + j] = has_w ? w8[k] : 0.0f;
      }
      for (int k = 8; k < a.c; ++k) {
        const bool mine_k = has_w && (a.radii_mode != 2 || k == channel);
        wt[static_cast<size_t>(k) * vo + j] = mine_k ? __ldg(wrow + k) : 0.0f;
      }
    }
    __syncthreads();  // the staged atoms are read below

    // plane ranges: one warp per (row tile, chunk) pair of these chunks,
    // pair = t * mine + chunk, warp w taking pairs w, w + nwarps, ...
    const int npairs = a.nht * mine;
    const int step_t = nwarps / mine, step_c = nwarps % mine;
    int t = warp / mine, vcl = warp % mine;
    for (int pair = warp; pair < npairs; pair += nwarps) {
      const float h_lo = __fadd_rn(__fmul_rn(static_cast<float>(t * a.ht), a.res), a.lb);
      const float h_hi = __fadd_rn(h_lo, a.h_step);
      int lo = a.dl, hi = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 atom = stage[vcl * kChunk + half * 32 + lane];
        const float x = atom.x, y = atom.y, dz2 = atom.z, r2 = atom.w;
        const float dy = fmaxf(fmaxf(__fsub_rn(h_lo, y), __fsub_rn(y, h_hi)), 0.0f);
        const float s2 = __fsub_rn(r2, __fadd_rn(__fmul_rn(dy, dy), dz2));
        if (!(s2 < 0.0f)) {  // else the atom misses the tile: (Dl, 0), the bounds lo and hi start from
          const float s = __fadd_rn(__fmul_rn(__fsqrt_rn(fmaxf(s2, 0.0f)), one_plus), pad);
          float flo = ceilf(__fmul_rn(__fsub_rn(__fsub_rn(x, s), a.lb), a.inv_res));
          float fhi = __fadd_rn(floorf(__fmul_rn(__fsub_rn(__fadd_rn(x, s), a.lb), a.inv_res)), 1.0f);
          flo = fminf(fmaxf(flo, 0.0f), static_cast<float>(a.dl));
          fhi = fminf(fmaxf(fhi, 0.0f), static_cast<float>(a.dl));
          lo = min(lo, static_cast<int>(flo));
          hi = max(hi, static_cast<int>(fhi));
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        out[(t * nvc + s0 + vcl) * 2 + 0] = lo;
        out[(t * nvc + s0 + vcl) * 2 + 1] = max(hi, lo);  // all-empty chunks become d_hi == d_lo
      }
      vcl += step_c;
      t += step_t;
      if (vcl >= mine) vcl -= mine, ++t;
    }
    __syncthreads();  // the next chunks overwrite the staged atoms
  }
  if (sorted_here && remote_ranks) cluster.sync();  // no block exits while another may still read its sort words
}

int check_args(const Args& a, int batch, int threads, size_t smem) {
  const int nvc = a.vo / kChunk;
  if (batch <= 0 || a.v <= 0 || a.vp < a.v || a.vp % kChunk != 0 || a.c <= 0 || a.vo % kChunk != 0 ||
      a.vo != (a.radii_mode == 2 ? a.c * a.vp : a.vp) || a.dl <= 0 || a.dim <= 0 || a.ht < 1 || a.nht < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || a.vp > 65536 || a.radii_mode < 0 ||
      a.radii_mode > 2 || ((a.rot || a.trans) && a.table == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.split < 1 || a.cpb < 1 || static_cast<long long>(a.split) * a.cpb < nvc ||
      static_cast<long long>(batch) * a.split > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.sort && (a.split > kMaxCluster || a.seg < 32 || a.seg % 32 != 0 || a.seg > threads * kItems ||
                 static_cast<long long>(a.seg) * a.split < a.vp || a.oseg < 1 ||
                 static_cast<long long>(a.oseg) * a.split < a.vp || threads < kSortThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem != smem_bytes(a.sort, a.vp, a.seg, a.oseg, a.split, threads, a.cpb) || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// Constants the Python side plans with (molvoxel_torch/ops/deposit.py).
int deposit_prep_chunk() { return kChunk; }
int deposit_prep_max_threads() { return kMaxThreads; }
int deposit_prep_items() { return kItems; }
int deposit_prep_stage() { return kStage; }
int deposit_prep_search_share() { return kSearchShare; }

// Readies the kernel on the current device (the shared memory it may ask
// for, clusters above the portable 8 blocks) and returns how many clusters
// of 16 of its largest blocks the device runs at once
// (cudaOccupancyMaxActiveClusters; 0 where it runs none, and the wrapper
// then launches clusters of at most 8), or minus the cudaError_t of a
// failed call.
int deposit_prep_setup() {
  const void* fn = reinterpret_cast<const void*>(deposit_prep_kernel);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemMax));
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = kSmemMax;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused query leaves no error behind: no cluster of 16
    clusters = 0;
  }
  return clusters;
}

// One launch of B x split blocks of `threads` with `smem` bytes of dynamic
// shared memory (smem_bytes), block s of a molecule writing its output
// chunks [s * cpb, (s + 1) * cpb).  sort: each molecule's `split` blocks
// are one cluster that Morton-sorts its atoms, block s keying the atoms
// [s * seg, (s + 1) * seg) and receiving the ranks [s * oseg, (s + 1) *
// oseg).  deposit_prep_setup must have run on the current device.  Returns
// the cudaError_t of the launch (0 on success), a refused cluster launch
// included; nothing is synchronised.
int deposit_prep(const void* coords, const void* weights, const void* radii, const void* mask, const void* centers,
                 const void* table, void* rows, void* wt, void* ranges, void* perm, int batch, int v, int vp, int c,
                 int vo, int dl, int dim, int ht, int nht, int split, int cpb, int seg, int oseg, int radii_mode,
                 int rot, int trans, int sort, int key_after, int gaussian, int notrunc, float lb, float ub,
                 float scale, float res, float inv_res, float shift, float h_step, float coef_k, float notrunc_k,
                 int threads, int smem, void* stream) {
  Args a{static_cast<const float*>(coords), static_cast<const float*>(weights), static_cast<const float*>(radii),
         static_cast<const uint8_t*>(mask), static_cast<const float*>(centers), static_cast<const float*>(table),
         static_cast<float*>(rows), static_cast<float*>(wt), static_cast<int*>(ranges), static_cast<int*>(perm),
         v, vp, c, vo, dl, dim, ht, nht, split, cpb, seg, oseg, radii_mode, rot, trans, sort, key_after,
         gaussian, notrunc, lb, ub, scale, res, inv_res, shift, h_step, coef_k, notrunc_k};
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = check_args(a, batch, threads, static_cast<size_t>(smem));
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * split));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = sort ? 1 : 0;  // one cluster a sorted molecule
  return static_cast<int>(cudaLaunchKernelEx(&cfg, deposit_prep_kernel, a));
}

}  // extern "C"
