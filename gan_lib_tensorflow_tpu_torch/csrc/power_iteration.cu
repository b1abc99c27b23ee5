// Batched spectral-norm power iteration: one step for every SN weight of a
// discriminator in a single launch.
//
// Replaces gan_lib_tensorflow_tpu/ops/pallas_kernels.py:63
// batched_power_iteration (body _power_iter_kernel, :46). For each weight i,
// with W_i in R^{M x K} ([fan_in, out]) and u_i in R^K:
//   v = l2n(u W^T),  u' = l2n(v W),  sigma = v W u'^T
// with l2n(x) = x * rsqrt(sum(x^2) + 1e-12), as the reference does.
//
// Layout. The Pallas kernel took one zero-padded [N, Mmax, Kmax] stack (8/128
// padding was a TPU tiling rule). This kernel reads every weight ragged, in
// the port's own layout: a conv weight in OIHW (or a Dense weight [out, in])
// is exactly W^T as a row-major [K, M] matrix, so nothing is transposed,
// padded or packed. The wrapper (ops/power_iteration.py) plans the work on
// the host once per discriminator (plan_power_iteration, a pure function of
// the shapes, tested on the CPU) and writes a device table with one int64
// row per CTA:
//   (w_ptr, u_ptr, M, K, v_offset, u_offset, col0, width, kind, weight)
// and, after them, one row per work item of the streaming CTAs (below):
//   (w_ptr, u_ptr, M, K, v_offset, u_offset, col0, ncols, weight, part,
//    parts, ws_base)
// Parameters are updated in place, so their pointers stay valid across steps.
//
// Bound. The bytes of W, read once: on the CIFAR discriminator (11 weights,
// 1,052,544 fp32 values) 4.21 MB, 1.270 us at 3.35 TB/s with u in and
// sigma, u' and v out; on the ImageNet-128 discriminator (19 weights, 157.7
// MB) 47.17 us. The arithmetic, 4*M*K flops per weight, takes 1/33 of that
// at the 67 TFLOP/s fp32 rate, so the bound is bytes.
//
// Two paths, each its own kernel; the planner picks one per launch:
//
// 1. Slabs in shared memory, when every weight's slab fits (the CIFAR
//    discriminators). The launch has a cluster dimension of 8 CTAs (the
//    portable size). A weight larger than 64 KB gets a whole cluster: CTA c
//    owns the columns [col0, col0 + width) of W^T, width = M / 8 rounded up
//    to 4 (a [1152, 128] weight: 144 columns, a 72 KB slab). It loads its
//    slab once with cp.async (16-byte copies when aligned), computes its v
//    slice (each warp a set of rows, each lane 8 columns 32 apart), then,
//    from the same slab and before v is normalised, its K partial sums of
//    W^T v; pushes its |v|^2 partial and its K sums into the shared memory
//    of every rank of its cluster (distributed shared memory stores, never
//    remote loads); waits once at a cluster barrier; and every rank adds the
//    same partials in rank order. The small weights take one CTA each,
//    packed into clusters of their own. 7.06-7.29 us per CIFAR launch (PRs
//    3-15) against a 1.03 us floor.
//
// 2. Streamed, when a weight's slab, split over a cluster, does not fit in
//    227 KB (the ImageNet-128 discriminator: 9 of its 19 weights, 154.8 MB).
//    PR 3 streamed each such weight through one cluster of 8 CTAs and read
//    W twice, so 24 SMs carried the three 37.75 MB weights (1011 us). Here
//    every weight of the launch is cut into tiles of all its K rows by TC
//    columns, and the tiles, in order, are dealt to one CTA per SM (no
//    clusters), each about the same cost (bytes, plus a fixed cost per tile
//    and per weight); a CTA's run of tiles within one weight is a work item,
//    part p of the weight. TC = 32 up to K = 1024, so that each row of W^T
//    is read 128 bytes at a time (64-byte pieces read markedly slower on the
//    card). Each CTA:
//      - keeps a ring of up to 13 chunk slots of 16 KB (128 rows of a tile
//        at TC = 32), filled by cp.async 16-byte copies (zero-filled past
//        the weight's edge; W marked first to leave L2), one commit group
//        per chunk: a tile of 1024 rows takes 8 slots, and the next tile's
//        first 5 chunks load while it is computed; the 16-byte pieces of a
//        row are XOR-swizzled so that both passes read shared memory without
//        bank conflicts;
//      - from each tile, computes the tile's v (un-normalised; each thread a
//        float4 of columns over a set of rows, chunk by chunk as they come
//        in, the sets added by shuffles and then in warp order), writes it
//        to v, and adds the tile's W^T v into its item's K partial sums (one
//        thread per row, the columns in order): W is read from device
//        memory once;
//      - at the end of an item writes its K partial sums and its |v|^2
//        partial to a workspace slot of its own (part p of the weight),
//        fences, and takes a ticket from the weight's counter; the CTA that
//        takes the last ticket adds the parts in part order (never in
//        arrival order), scales by 1/|v| (a scalar, so it applies once at
//        the end), and writes sigma, u' and the rescaled v, then resets the
//        counter for the next launch. Its loads are batched (16 parts, or
//        16 values of v, in flight at a time): this last step is the
//        launch's tail.
//    93.70-94.11 us for the ImageNet-128 D's 19 weights (chip_smoke.py
//    phase 11, PR 16) against a 47.17 us bound.
//
// No floating-point atomics, and every sum is taken in a fixed order, so two
// launches on the same inputs give bit-identical sigma, u' and v. v and u'
// go to flat output buffers (the backward needs both); u' is also written
// into the u buffers when the caller asks. The kernel allocates nothing and
// launches on the caller's stream; the workspace and the counters belong to
// the wrapper's table (one launch of a table at a time). A refused launch
// (cluster or shared-memory request) comes back as the cudaError_t and the
// wrapper raises.
//
// Measured by chip_smoke.py phases 8 and 11 (device time of CUDA-graph
// replays; PERF.md section 6 has every run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // = 32 * WARPS in ops/power_iteration.py
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;             // columns per lane in the v pass
constexpr int kChunk = 32 * kCols;   // columns per chunk of the v pass
constexpr int kRows = 8;             // rows of W^T one warp reduces at a time in the u' pass
constexpr int kCluster = 8;  // CTAs per cluster, the portable size; CLUSTER in ops/power_iteration.py
constexpr int kTableCols = 10;
constexpr int kItemCols = 12;
// floats of one chunk slot of a streaming CTA (16 KB), CHUNK_FLOATS there
constexpr int kChunkFloats = 4096;
constexpr int kMaxSlots = 13;       // MAX_SLOTS there
constexpr int kMaxRowQuads = 4;     // rows of a streamed weight: at most 4 x 4 x kThreads = 4096

// a streaming CTA's shared memory besides its slots, u and the partial sums:
// the warps' v partials, the tile's v, block_sum's scratch and the ticket
constexpr int kStreamSmallFloats = kWarps * 32 + 32 + 16 + 4;
constexpr int kMaxDevices = 64;

enum Kind { kIdle = 0, kSolo = 1, kSplit = 2, kStream = 3 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum of x over the block in a fixed order; every thread gets the result.
// scratch holds kWarps + 1 floats.
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? scratch[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) scratch[kWarps] = t;
  }
  __syncthreads();
  return scratch[kWarps];
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// An L2 policy that evicts first what it is attached to: W, read once, then
// does not push the partial sums the last CTA of a weight reads out of L2.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// the same copies with only src_bytes read and the rest of the 16 (or 4)
// bytes zero-filled; the 16-byte one with an L2 policy
__device__ __forceinline__ void cp_async16_fill(float* smem, const float* gmem, int src_bytes,
                                                unsigned long long policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async4_fill(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------- path 1

// Shared memory of one clustered CTA, in floats; plan_power_iteration
// computes the same sum. First the part that peers write into, at offsets
// that depend only on (nranks, K) and so are the same on every rank of a
// weight: the |v|^2 partial of each rank and each rank's K partial sums of
// W^T v. Then the slab (16-byte aligned), u, the v slice, the row-group
// partials of the v pass and block_sum's scratch.
__device__ __forceinline__ int peer_floats(int nranks, int k) {
  return kCluster + ((nranks * k + 3) & ~3);
}

__device__ __forceinline__ long long smem_floats(int k, int width, int nranks) {
  return peer_floats(nranks, k) + static_cast<long long>(k) * width + k + width +
         kWarps * kChunk + kWarps + 1;
}

// The CTA's slab of W^T, row r and column j (0 <= j < width).
struct SharedSlab {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int j) const { return p[r * ld + j]; }
};


struct Work {
  float* u;
  float* sigma;
  float* u_out;
  float* v_out;
  long long v_off, u_off;
  int k, col0, width, weight, write_u;
  int rank, nranks;
  bool split;
  float* red_v;  // [kCluster] |v|^2 partial of each rank
  float* ygath;  // [nranks, K] each rank's partial sums of W^T v
  float* su;     // [K] u
  float* sv;     // [width] v slice
  float* vpart;  // [kWarps, kChunk] partials of the v pass
  float* scratch;
};

// Steps 2-5 for one CTA (see the file's note). Ranks never read remote
// shared memory: each pushes its partials into every peer's shared memory,
// and one cluster barrier orders the pushes before the reads. After it every
// rank adds the same partials in the same order, so all ranks agree on
// |v|, W^T v and |W^T v| without a second barrier.
template <class Slab>
__device__ __forceinline__ void slab_step(const Slab& S, const Work& w) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = w.k;

  // 2. the v slice before normalising, v_j = sum_r u_r W^T[r, j]: warp g
  // adds the rows r = g (mod kWarps), each lane kCols columns 32 apart; the
  // kWarps partials of a column are then added in order
  for (int c0 = 0; c0 < w.width; c0 += kChunk) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int r = warp; r < k; r += kWarps) {
      const float ur = w.su[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = c0 + lane + 32 * c;
        if (j < w.width) acc[c] = fmaf(ur, S(r, j), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) w.vpart[warp * kChunk + lane + 32 * c] = acc[c];
    __syncthreads();
    for (int j = tid; j < kChunk && c0 + j < w.width; j += kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) x += w.vpart[g * kChunk + j];
      w.sv[c0 + j] = x;
    }
    __syncthreads();  // vpart is free for the next chunk
  }
  float ss = 0.0f;
  for (int j = tid; j < w.width; j += kThreads) ss = fmaf(w.sv[j], w.sv[j], ss);
  ss = block_sum(ss, w.scratch);

  // 3. this slab's K partial sums of W^T v (v not yet normalised): warp g
  // takes kRows rows at a time, r = g + kWarps * t, so their loads and
  // shuffle trees overlap; the partials go to this rank's slot of ygath
  float* mine = w.ygath + w.rank * k;
  for (int rb = warp; rb < k; rb += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.0f;
#pragma unroll 4
    for (int j = lane; j < w.width; j += 32) {
      const float x = w.sv[j];
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        if (rb + kWarps * t < k) acc[t] = fmaf(S(rb + kWarps * t, j), x, acc[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
    }
    float y = acc[0];
#pragma unroll
    for (int t = 1; t < kRows; ++t) y = lane == t ? acc[t] : y;
    if (lane < kRows && rb + kWarps * lane < k) mine[rb + kWarps * lane] = y;
  }
  if (tid == 0) w.red_v[w.rank] = ss;
  __syncthreads();

  // 4. push this rank's partials into every peer, then the one barrier
  if (w.split) {
    cg::cluster_group cluster = cg::this_cluster();
    // a rank may write into a peer's shared memory only once the peer runs:
    // this waits on the arrival every rank made on entry
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int i = tid; i < w.nranks * k; i += kThreads) {
      const int q = i / k, r = i - q * k;
      if (q != w.rank) cluster.map_shared_rank(mine, q)[r] = mine[r];
    }
    if (tid < w.nranks && tid != w.rank) cluster.map_shared_rank(w.red_v, tid)[w.rank] = ss;
    cluster.sync();  // the last access to a peer's shared memory is before this barrier
  }

  // 5. every rank adds the partials in rank order: |v|^2, then W^T v, then
  // |W^T v|^2; it writes its v slice and its share of the rows of u'
  float ssv = 0.0f;
  for (int q = 0; q < w.nranks; ++q) ssv += w.red_v[q];
  const float inv_v = rsqrtf(ssv + 1e-12f);
  for (int j = tid; j < w.width; j += kThreads) w.v_out[w.v_off + w.col0 + j] = w.sv[j] * inv_v;
  float ss2 = 0.0f;
  for (int r = tid; r < k; r += kThreads) {
    float y = 0.0f;
    for (int q = 0; q < w.nranks; ++q) y += w.ygath[q * k + r];
    y *= inv_v;
    w.ygath[r] = y;  // rank 0's slot of row r: no other thread reads it now
    ss2 = fmaf(y, y, ss2);
  }
  const float s = block_sum(ss2, w.scratch);
  const float inv_u = rsqrtf(s + 1e-12f);
  if (w.rank == 0 && tid == 0) w.sigma[w.weight] = s * inv_u;  // (W^T v) . u'
  const int rows = (k + w.nranks - 1) / w.nranks;
  const int r1 = min(k, (w.rank + 1) * rows);
  for (int r = w.rank * rows + tid; r < r1; r += kThreads) {
    const float x = w.ygath[r] * inv_u;
    w.u_out[w.u_off + r] = x;
    if (w.write_u) w.u[r] = x;  // every rank read u in step 1, before the barrier
  }
}

__device__ __forceinline__ void slab_cta(const long long* row, int kind, float* sigma,
                                         float* u_out, float* v_out, int write_u, float* smem) {
  const float* w = reinterpret_cast<const float*>(row[0]);  // W^T [K, M]
  const int m = static_cast<int>(row[2]);
  Work wk;
  wk.u = reinterpret_cast<float*>(row[1]);
  wk.sigma = sigma;
  wk.u_out = u_out;
  wk.v_out = v_out;
  wk.k = static_cast<int>(row[3]);
  wk.v_off = row[4];
  wk.u_off = row[5];
  wk.col0 = static_cast<int>(row[6]);
  wk.width = static_cast<int>(row[7]);
  wk.weight = static_cast<int>(row[9]);
  wk.write_u = write_u;
  // kind is the same on every rank of a cluster, so the cluster barriers are
  // reached by all of its CTAs or by none
  wk.split = kind == kSplit;
  wk.nranks = wk.split ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  wk.rank = wk.split ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  if (wk.split) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int k = wk.k, width = wk.width, col0 = wk.col0;
  const int tid = threadIdx.x;

  unsigned dyn_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_bytes));
  if (wk.nranks > kCluster || 4 * smem_floats(k, width, wk.nranks) > dyn_bytes)
    __trap();  // the planner and the kernel disagree
  wk.red_v = smem;
  wk.ygath = smem + kCluster;
  float* slab = smem + peer_floats(wk.nranks, k);
  wk.su = slab + static_cast<long long>(k) * width;
  wk.sv = wk.su + k;
  wk.vpart = wk.sv + width;
  wk.scratch = wk.vpart + kWarps * kChunk;

  // 1. the slab of W^T [K, width] into shared memory, once, all copies in
  // flight together; u beside it
  const bool vec = ((reinterpret_cast<uintptr_t>(w) & 15u) | (m & 3) | (col0 & 3) | (width & 3)) == 0;
  if (vec) {
    const int w4 = width / 4;
    for (int i = tid; i < k * w4; i += kThreads) {
      const int r = i / w4, c = 4 * (i - r * w4);
      cp_async16(slab + r * width + c, w + static_cast<long long>(r) * m + col0 + c);
    }
  } else {
    for (int i = tid; i < k * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      cp_async4(slab + r * width + c, w + static_cast<long long>(r) * m + col0 + c);
    }
  }
  for (int r = tid; r < k; r += kThreads) wk.su[r] = wk.u[r];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  slab_step(SharedSlab{slab, width}, wk);
}

// ---------------------------------------------------------------- path 2

// Columns of a streamed tile of K rows (tile_cols in ops/power_iteration.py):
// 32, so that each row of W^T is read 128 bytes at a time, up to K = 1024;
// then halved as K doubles, so that a tile stays within 8 chunks.
__device__ __forceinline__ int tile_cols(int k) {
  return k <= 1024 ? 32 : k <= 2048 ? 16 : 8;
}

// The 16-byte chunk q of row r of a tile of Q chunks per row sits at chunk
// q ^ swz(r): eight consecutive rows then put one chunk on eight different
// 4-bank groups, for the row-per-thread reads of the y pass, and the v
// pass's reads (Q threads along a row) stay conflict-free too.
template <int Q>
__device__ __forceinline__ int swz(int r) {
  constexpr int kShift = Q == 8 ? 0 : (Q == 4 ? 1 : 2);  // Q is 2, 4 or 8
  constexpr int kMask = Q == 8 ? 7 : Q - 1;
  return (r >> kShift) & kMask;
}

struct Item {
  const float* w;  // W^T [K, M]
  float* u;
  int m, k;
  long long v_off, u_off;
  int col0, ncols, weight, part, parts;
  long long ws_base;
  int tc, cr, h;  // tile columns, chunk rows, chunks per tile
  bool vec;
};

__device__ __forceinline__ Item read_item(const long long* items, int i) {
  const long long* p = items + static_cast<long long>(kItemCols) * i;
  Item it;
  it.w = reinterpret_cast<const float*>(p[0]);
  it.u = reinterpret_cast<float*>(p[1]);
  it.m = static_cast<int>(p[2]);
  it.k = static_cast<int>(p[3]);
  it.v_off = p[4];
  it.u_off = p[5];
  it.col0 = static_cast<int>(p[6]);
  it.ncols = static_cast<int>(p[7]);
  it.weight = static_cast<int>(p[8]);
  it.part = static_cast<int>(p[9]);
  it.parts = static_cast<int>(p[10]);
  it.ws_base = p[11];
  it.tc = tile_cols(it.k);
  it.cr = kChunkFloats / it.tc;
  it.h = (it.k + it.cr - 1) / it.cr;
  it.vec = ((reinterpret_cast<uintptr_t>(it.w) & 15u) | (it.m & 3)) == 0;
  return it;
}

// Chunk hh of a tile (its rows [hh cr, hh cr + cr), columns [c0, c0 + nc)
// of the item's run) into a slot; the columns past nc (a weight's ragged
// edge) are zero-filled.
template <int Q>
__device__ void load_chunk(float* slot, const Item& it, int c0, int hh) {
  constexpr int TC = 4 * Q;
  const int nc = min(TC, it.ncols - c0);
  const int r0 = hh * it.cr, nr = min(it.cr, it.k - r0);
  const float* base = it.w + static_cast<long long>(r0) * it.m + it.col0 + c0;
  if (it.vec) {
    const unsigned long long policy = evict_first_policy();
    for (int i = threadIdx.x; i < nr * Q; i += kThreads) {
      const int r = i / Q, q = i - r * Q;
      const int valid = min(4, max(0, nc - 4 * q));
      const float* src = base + static_cast<long long>(r) * it.m + (valid ? 4 * q : 0);
      cp_async16_fill(slot + r * TC + 4 * (q ^ swz<Q>(r)), src, 4 * valid, policy);
    }
  } else {
    for (int i = threadIdx.x; i < nr * TC; i += kThreads) {
      const int r = i / TC, j = i - r * TC;
      const bool ok = j < nc;
      cp_async4_fill(slot + r * TC + 4 * ((j >> 2) ^ swz<Q>(r)) + (j & 3),
                     base + static_cast<long long>(r) * it.m + (ok ? j : 0), ok ? 4 : 0);
    }
  }
}

// Wait until at most n of this thread's copy groups are pending (n < kMaxSlots).
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
#define GL_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    GL_WAIT(0) GL_WAIT(1) GL_WAIT(2) GL_WAIT(3) GL_WAIT(4) GL_WAIT(5) GL_WAIT(6)
    GL_WAIT(7) GL_WAIT(8) GL_WAIT(9) GL_WAIT(10) GL_WAIT(11)
#undef GL_WAIT
    default: asm volatile("cp.async.wait_group 12;\n" ::: "memory"); break;
  }
}

struct StreamSmem {
  float* ring;   // [slots, kChunkFloats]
  int slots;
  float* vpart;  // [kWarps, 32] the warps' v partials
  float* vt;     // [32] the tile's v
  float* scratch;
  int* last;     // this CTA took a weight's last ticket
  float* su;     // [K] u
  float* yacc;   // [K] the item's partial sums of W^T v (row r: thread r % kThreads)
};

// The chunk cursor: chunk n of the CTA's flat sequence of (item, tile,
// chunk) sits in slot n % slots; loads run ahead of the computation as far
// as the free slots allow, one commit group per chunk.
struct Cursor {
  const long long* items;
  int item, ie, c0, hh;
  Item it;
  __device__ bool more() const { return item < ie; }
  __device__ void next() {
    if (++hh == it.h) {
      hh = 0;
      c0 += it.tc;
      if (c0 >= it.ncols) {
        c0 = 0;
        if (++item < ie) it = read_item(items, item);
      }
    }
  }
};

__device__ __forceinline__ void issue_chunk(float* slot, const Item& it, int c0, int hh) {
  switch (it.tc) {
    case 32: load_chunk<8>(slot, it, c0, hh); break;
    case 16: load_chunk<4>(slot, it, c0, hh); break;
    default: load_chunk<2>(slot, it, c0, hh); break;
  }
  cp_async_commit();
}

// One tile (chunks [first, first + h) of the ring): its v (written to
// v_out un-normalised), its |v|^2 added to ss, and its W^T v added to the
// item's partial sums. The tile's chunks are waited for one by one, the v
// pass of each starting as soon as it is in. Every field of the item the
// loops read is copied into a register first: the stores into shared
// memory would otherwise make the compiler read them again.
template <int Q>
__device__ __forceinline__ void tile_step(const Item& it, int c0, int first, int& issued,
                                          Cursor& ld, const StreamSmem& sm, float* v_out,
                                          float& ss) {
  constexpr int TC = 4 * Q, RP = kThreads / Q, CR = kChunkFloats / TC;
  constexpr int kCrShift = TC == 32 ? 7 : (TC == 16 ? 8 : 9);  // log2(CR)
  static_assert((1 << kCrShift) == CR, "chunk rows");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = it.k, h = it.h, slots = sm.slots;
  const int nc = min(TC, it.ncols - c0);
  float* const ring = sm.ring;
  const float* const su = sm.su;
  float* const yacc = sm.yacc;
  float* const vt = sm.vt;
  const int s0 = first % slots;  // slot of chunk 0 of the tile
  auto slot_of = [&](int hh) {
    const int s = s0 + hh;
    return ring + (s >= slots ? s - slots : s) * kChunkFloats;
  };
  const int q = tid % Q;
  // v pass: thread (q, rr) adds chunk q of the rows rr, rr + RP, ... of every
  // chunk of the tile in turn; the lanes of a chunk within a warp are then
  // added by a shuffle tree, the warps in order
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int hh = 0; hh < h; ++hh) {
    wait_groups(issued - 1 - (first + hh));
    __syncthreads();  // chunk hh is in for every thread
    const float* slot = slot_of(hh);
    const float* u = su + hh * CR;
    const int nr = min(CR, k - hh * CR);
#pragma unroll 4
    for (int r = tid / Q; r < nr; r += RP) {
      const float4 t = *reinterpret_cast<const float4*>(slot + r * TC + 4 * (q ^ swz<Q>(r)));
      const float ur = u[r];
      acc.x = fmaf(ur, t.x, acc.x);
      acc.y = fmaf(ur, t.y, acc.y);
      acc.z = fmaf(ur, t.z, acc.z);
      acc.w = fmaf(ur, t.w, acc.w);
    }
  }
#pragma unroll
  for (int off = 16; off >= Q; off >>= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (lane < Q) *reinterpret_cast<float4*>(sm.vpart + warp * 32 + 4 * lane) = acc;
  __syncthreads();
  if (tid < TC) {
    float x = 0.0f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) x += sm.vpart[g * 32 + tid];
    vt[tid] = x;  // 0 past the weight's edge
    if (tid < nc) v_out[it.v_off + it.col0 + c0 + tid] = x;
  }
  __syncthreads();
  if (warp == 0) {  // |v|^2 of the tile: a fixed shuffle tree over its columns
    float x = lane < TC ? vt[lane] * vt[lane] : 0.0f;
    x = warp_sum(x);
    if (lane == 0) ss += x;
  }
  float4 v4[Q];
#pragma unroll
  for (int c = 0; c < Q; ++c) v4[c] = *reinterpret_cast<const float4*>(vt + 4 * c);
  // y pass: thread r % kThreads adds row r's dot with the tile's v, the
  // columns in order
  for (int r = tid; r < k; r += kThreads) {
    const float* row = slot_of(r >> kCrShift) + (r & (CR - 1)) * TC;
    const int s = swz<Q>(r & (CR - 1));
    float y = 0.0f;
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(row + 4 * (c ^ s));
      y = fmaf(t.x, v4[c].x, y);
      y = fmaf(t.y, v4[c].y, y);
      y = fmaf(t.z, v4[c].z, y);
      y = fmaf(t.w, v4[c].w, y);
    }
    yacc[r] += y;
  }
  __syncthreads();  // the tile's slots are free
  // refill the freed slots
  while (ld.more() && issued < first + h + slots) {
    const int s = issued % slots;
    issue_chunk(ring + s * kChunkFloats, ld.it, ld.c0, ld.hh);
    ++issued;
    ld.next();
  }
}

// A part's slot in the workspace: K partial sums padded to a multiple of 4
// (16-byte rows of four), then |v|^2 (ws_stride in ops/power_iteration.py).
__device__ __forceinline__ int ws_stride(int k) { return ((k + 3) & ~3) + 4; }

// The last CTA of a weight: add the parts' sums in part order, then sigma,
// u' and the rescaled v.
__device__ void finish_weight(const Item& it, const float* ws, int* counters, float* sigma,
                              float* u_out, float* v_out, int write_u, const StreamSmem& sm) {
  const int tid = threadIdx.x, k = it.k, k4 = (k + 3) & ~3;
  const long long stride = ws_stride(k);
  const float* base = ws + it.ws_base;
  __threadfence();  // the other parts' writes, seen through their tickets
  float ssv = 0.0f;  // the same sum in every thread, in part order
  int p0 = 0;
  for (; p0 + 16 <= it.parts; p0 += 16) {
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = __ldcg(base + (p0 + i) * stride + k4);
#pragma unroll
    for (int i = 0; i < 16; ++i) ssv += x[i];
  }
  for (; p0 < it.parts; ++p0) ssv += __ldcg(base + p0 * stride + k4);
  const float inv_v = rsqrtf(ssv + 1e-12f);
  float* uo = u_out + it.u_off;
  float ss2 = 0.0f;
  // rows four at a time (at most kMaxRowQuads per thread), each in part
  // order, 16 parts' loads in flight; the sums stay in registers
  float4 yq[kMaxRowQuads];
#pragma unroll
  for (int q = 0; q < kMaxRowQuads; ++q) {
    const int r = 4 * (tid + q * kThreads);
    float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < k) {
      int p = 0;
      for (; p + 16 <= it.parts; p += 16) {
        float4 x[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          x[i] = __ldcg(reinterpret_cast<const float4*>(base + (p + i) * stride + r));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          y.x += x[i].x;
          y.y += x[i].y;
          y.z += x[i].z;
          y.w += x[i].w;
        }
      }
      for (; p < it.parts; ++p) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(base + p * stride + r));
        y.x += x.x;
        y.y += x.y;
        y.z += x.z;
        y.w += x.w;
      }
      y = make_float4(y.x * inv_v, y.y * inv_v, y.z * inv_v, y.w * inv_v);
      const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r + i < k) ss2 = fmaf(ys[i], ys[i], ss2);
    }
    yq[q] = y;
  }
  // the first v values to rescale, loaded while the block sums
  float* v = v_out + it.v_off;
  float vx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = tid + i * kThreads;
    vx[i] = j < it.m ? __ldcg(v + j) : 0.0f;
  }
  const float s = block_sum(ss2, sm.scratch);
  const float inv_u = rsqrtf(s + 1e-12f);
  if (tid == 0) {
    sigma[it.weight] = s * inv_u;  // (W^T v) . u'
    counters[it.weight] = 0;       // ready for the next launch
  }
#pragma unroll
  for (int q = 0; q < kMaxRowQuads; ++q) {
    const int r = 4 * (tid + q * kThreads);
    const float ys[4] = {yq[q].x * inv_u, yq[q].y * inv_u, yq[q].z * inv_u, yq[q].w * inv_u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i < k) {
        uo[r + i] = ys[i];
        if (write_u) it.u[r + i] = ys[i];  // every part read u before its ticket
      }
    }
  }
  // v rescaled, sixteen loads in flight before their stores (the stores
  // could otherwise alias the next loads, and each load would wait on the
  // last)
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = tid + i * kThreads;
    if (j < it.m) v[j] = vx[i] * inv_v;
  }
  for (int j0 = tid + 16 * kThreads; j0 < it.m; j0 += 16 * kThreads) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = j0 + i * kThreads;
      vx[i] = j < it.m ? __ldcg(v + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = j0 + i * kThreads;
      if (j < it.m) v[j] = vx[i] * inv_v;
    }
  }
}

__device__ __forceinline__ void stream_cta(const long long* row, const long long* items, float* ws,
                                        int* counters, float* sigma, float* u_out, float* v_out,
                                        int write_u, float* smem) {
  const int tid = threadIdx.x;
  const int ib = static_cast<int>(row[6]), ie = ib + static_cast<int>(row[7]);
  StreamSmem sm;
  sm.slots = static_cast<int>(row[9]);
  unsigned dyn_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_bytes));
  const int kmax =
      (static_cast<int>(dyn_bytes / 4) - sm.slots * kChunkFloats - kStreamSmallFloats) / 2;
  if (sm.slots < 2 || sm.slots > kMaxSlots || kmax < 1)
    __trap();  // the planner and the kernel disagree
  sm.ring = smem;
  sm.vpart = sm.ring + sm.slots * kChunkFloats;
  sm.vt = sm.vpart + kWarps * 32;
  sm.scratch = sm.vt + 32;
  sm.last = reinterpret_cast<int*>(sm.scratch + 16);
  sm.su = sm.scratch + 20;
  sm.yacc = sm.su + kmax;

  Cursor ld{items, ib, ie, 0, 0, read_item(items, ib)};
  int issued = 0;  // chunks issued so far
  while (ld.more() && issued < sm.slots) {
    issue_chunk(sm.ring + issued * kChunkFloats, ld.it, ld.c0, ld.hh);
    ++issued;
    ld.next();
  }
  int first = 0;  // the next tile's first chunk
  for (int ci = ib; ci < ie; ++ci) {
    const Item it = read_item(items, ci);
    if (it.k > kmax || it.h > sm.slots) __trap();  // the planner and the kernel disagree
    for (int r = tid; r < it.k; r += kThreads) {
      sm.su[r] = it.u[r];
      sm.yacc[r] = 0.0f;
    }
    float ss = 0.0f;  // warp 0's lane 0: |v|^2 of the item, tile by tile
    for (int c0 = 0; c0 < it.ncols; c0 += it.tc) {
      switch (it.tc) {
        case 32: tile_step<8>(it, c0, first, issued, ld, sm, v_out, ss); break;
        case 16: tile_step<4>(it, c0, first, issued, ld, sm, v_out, ss); break;
        default: tile_step<2>(it, c0, first, issued, ld, sm, v_out, ss); break;
      }
      first += it.h;
    }
    // the item's partial sums and |v|^2 to its slot, then the ticket
    float* part = ws + it.ws_base + static_cast<long long>(it.part) * ws_stride(it.k);
    for (int r = tid; r < it.k; r += kThreads) part[r] = sm.yacc[r];
    if (tid == 0) part[(it.k + 3) & ~3] = ss;
    __threadfence();
    __syncthreads();
    if (tid == 0) *sm.last = atomicAdd(counters + it.weight, 1) == it.parts - 1;
    __syncthreads();
    if (*sm.last) finish_weight(it, ws, counters, sigma, u_out, v_out, write_u, sm);
    __syncthreads();  // u, yacc and the ticket flag are free for the next item
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- kernel

// Path 1: a launch in clusters of kCluster, every weight's slab in shared
// memory.
__global__ void __launch_bounds__(kThreads)
power_iteration_kernel(const long long* __restrict__ table, float* __restrict__ sigma,
                       float* __restrict__ u_out, float* __restrict__ v_out, int write_u) {
  extern __shared__ __align__(16) float smem[];
  const long long* row = table + kTableCols * static_cast<long long>(blockIdx.x);
  const int kind = static_cast<int>(row[8]);
  if (kind == kIdle) return;  // a spare rank of a packed cluster
  slab_cta(row, kind, sigma, u_out, v_out, write_u, smem);
}

// Path 2: a launch without clusters, every weight streamed.
__global__ void __launch_bounds__(kThreads)
power_iteration_kernel_streamed(const long long* __restrict__ table,
                                const long long* __restrict__ items, float* __restrict__ ws,
                                int* __restrict__ counters, float* __restrict__ sigma,
                                float* __restrict__ u_out, float* __restrict__ v_out,
                                int write_u) {
  extern __shared__ __align__(16) float smem[];
  const long long* row = table + kTableCols * static_cast<long long>(blockIdx.x);
  if (static_cast<int>(row[8]) != kStream) return;  // no items left for it
  stream_cta(row, items, ws, counters, sigma, u_out, v_out, write_u, smem);
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// Launch `kernel` on n_ctas blocks of kThreads in clusters of kCluster, with
// smem_bytes of dynamic shared memory. The attribute is set once per device
// and size. A refused call's error is returned and cleared, so that it does
// not surface again at the next launch.
int set_smem(const void* kernel, int* smem_set, int smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem_bytes;
  }
  return 0;
}

// The launch configuration: n_ctas blocks of kThreads, in clusters of
// kCluster when `cluster`.
cudaLaunchConfig_t config_of(int n_ctas, int smem_bytes, bool cluster, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_ctas));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster ? 1 : 0;
  return config;
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int* smem_set, int n_ctas, int smem_bytes, bool cluster,
           cudaStream_t stream, Args... args) {
  if (n_ctas <= 0) return 0;
  if (cluster && n_ctas % kCluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(kernel), smem_set, smem_bytes);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = config_of(n_ctas, smem_bytes, cluster, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

int g_slab_smem_set[kMaxDevices] = {};
int g_stream_smem_set[kMaxDevices] = {};
int g_empty_smem_set[kMaxDevices] = {};

}  // namespace

extern "C" {

// table: device int64 [n_ctas, 10] from plan_power_iteration; sigma: fp32
// [number of weights]; u_out: fp32 [sum K]; v_out: fp32 [sum M]. With
// `streams` 0, n_ctas is a multiple of kCluster and the launch is path 1's,
// in clusters. With `streams` 1, it is path 2's: items is int64 [n_items,
// 12], ws the items' partial sums (fp32), counters int32 [number of
// weights], zero before the first launch (each launch leaves them zero).
// Returns the cudaError_t of the launch (0 on success).
int gl_power_iteration(const void* table, int n_ctas, const void* items, int streams,
                       void* ws, void* counters, int smem_bytes, void* sigma, void* u_out,
                       void* v_out, int write_u, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto tab = static_cast<const long long*>(table);
  if (streams)
    return launch(power_iteration_kernel_streamed, g_stream_smem_set, n_ctas, smem_bytes,
                  false, s, tab, static_cast<const long long*>(items), static_cast<float*>(ws),
                  static_cast<int*>(counters), static_cast<float*>(sigma),
                  static_cast<float*>(u_out), static_cast<float*>(v_out), write_u);
  return launch(power_iteration_kernel, g_slab_smem_set, n_ctas, smem_bytes, true, s, tab,
                static_cast<float*>(sigma), static_cast<float*>(u_out),
                static_cast<float*>(v_out), write_u);
}

// How many CTAs of path 2's kernel, with smem_bytes of shared memory each,
// the current device holds at once (a negative cudaError_t on failure):
// the planner's streaming CTAs.
int gl_power_iteration_max_ctas(int smem_bytes) {
  int err = set_smem(reinterpret_cast<const void*>(power_iteration_kernel_streamed),
                     g_stream_smem_set, smem_bytes);
  if (err != 0) {
    cudaGetLastError();
    return -err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, power_iteration_kernel_streamed,
                                                      kThreads, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return sms * per_sm;
}

// An empty kernel launched with the same grid, clusters (when `cluster`) and
// shared memory: the floor that launching alone costs.
int gl_power_iteration_empty(int n_ctas, int smem_bytes, int cluster, void* stream) {
  return launch(empty_kernel, g_empty_smem_set, n_ctas, smem_bytes, cluster != 0,
                static_cast<cudaStream_t>(stream));
}


const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
