// Row-gather sum as one-hot matrix products on the tensor cores (the gather
// probe's one-hot formulation), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas probe kernels `onehot_kernel_v` and
// `onehot_kernel_bf16` (tools/roofline_microbench.py:80, :97, both through
// `_make_onehot_any`, pl.pallas_call at :155). It computes the function of
// gather_rows.cu (K3),
//
//   out[bm, q, :] = ((t_0 + t_1) + t_2) + ...,  t_k = table[bm, idx[bm, k, q], :]
//
// as K products A_k @ table[bm] with the one-hot selector
// A_k[q, s] = (idx[bm, k, q] == s), each product kept in its own f32
// accumulator and the K accumulators added in k order with ordinary f32 adds,
// as the Pallas kernel does (:86-90). Each accumulator element receives
// exactly one nonzero product 1 * table[s, n], so it holds table[s, n] exactly
// whatever rounding the tensor core's own accumulation uses, and the result is
// bitwise equal to the plain version -- for bf16 tables, and for f32 tables
// whose values TF32 holds exactly (the probe's table is bf16-representable;
// the f32 path feeds the raw f32 bits to TF32, which uses their top 19).
// An index outside [0, S) selects nothing and adds a zero row.
//
// bf16 tables use mma.sync m16n8k16 (bf16 in, f32 accumulate); f32 tables use
// TF32 mma.sync m16n8k8.
//
// What bounds it on the H100: the function needs only bytes, 0.079 ms at the
// production shapes (BM 32, QP 13312, K 4, S 2500), as K3's. The dense
// one-hot products would take 1.10 ms (bf16, 989 TFLOP/s) or 2.20 ms (TF32,
// 495 TFLOP/s), but for each k a query hits one row, so most (16 queries x
// one k-step) fragments are all zeros: at S 2500 with random addresses only
// 0.097 (bf16) or 0.050 (TF32) of them hold a one, 0.11 ms of products (the
// probe's `onehot_hit_tc_bound_ms`). What is left is the table's trips from
// L2 into shared memory, once per 64-query pass for every chunk the pass
// walks: about all of them with random addresses (4.3 GB bf16, 8.5 GB f32 a
// call at S 2500, the probe's `staged_mb`), a few with coherent ones; and the
// instructions a warp spends on each chunk and each hit fragment.
//
// What the design does about it. A block of 16 warps takes `qt` queries of
// one bm in passes of 64: 4 row blocks of 16 queries, and a row block's 4
// warps split its K products (at K 4 one k each, all 128 channels: 16 MMA
// tiles of 8, 64 f32 accumulators a thread). The table streams through
// shared memory in chunks of 16 MMA k-steps (256 rows bf16, 128 f32):
// 1. fragments: at each chunk a warp ORs over its lanes (`__reduce_or_sync`)
//    which k-steps its 16 rows hit, and walks those bits alone, one
//    `mma.sync` per 8-channel tile each, on warp-uniform branches. The A
//    fragment is built in registers by comparing the rows' indices with the
//    k-step's row numbers;
// 2. chunks: warp 0 first sets bit c % 32 for each chunk c that the block's
//    first pass's 64 x K indices fall in. When at least 15/16 of min(chunks,
//    32) bits are set (random addresses, where lists cost more than they
//    save) the block walks every chunk. Else, for each group of 8 passes, it
//    marks the chunks each pass selects (bitmasks in shared memory,
//    `atomicOr`) and compacts them into lists, a group ahead of the walk, so
//    that loads run on across passes;
// 3. staging: a ring of 2 slots of one chunk each, filled by tensor-map
//    TMA loads (`cp.async.bulk.tensor` of 128-byte column boxes,
//    128-byte swizzle, so that fragment reads are free of bank conflicts, or
//    2-way in TF32) behind a "full" mbarrier, and released by each warp on an
//    "empty" mbarrier. Thread 0 loads a slot as soon as every warp has
//    released it; no other barrier guards a chunk. bf16 B fragments come from
//    `ldmatrix.trans` on the row-major stage; TF32 ones are 32-bit shared
//    loads;
// 4. the K sums: a row block's warps add their accumulators in k order
//    through shared memory at the end of a pass, the last k writing the
//    output with streaming stores.
// Chunks of 16 k-steps pay a warp's fixed cost per chunk (its reduction,
// waits and release) over more rows than chunks of 4 or 8 did; the ring then
// holds two of them. Rows past S are filled with zeros by the TMA unit (the
// map's bound), so a k-step that straddles S multiplies zeros. Sharing each
// staged chunk between the blocks of a 2- or 4-block cluster by TMA
// multicast halved the L2 reads and ran 1.2-2.7x slower (each chunk then
// waits on every block's warps), so it is not kept. At S 2500 with random
// addresses this reaches about 1.2 ms TF32 and 0.73 ms bf16 on an H100 (the
// first design: 7.4 and 5.0); the design steps' timings: PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                   // at run time, so nothing more is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;          // table row width (channels)
constexpr int kWarps = 16;         // 4 row blocks x 4 warps
constexpr int kThreads = kWarps * 32;
constexpr int kPassRows = 64;      // queries per pass
constexpr int kStepsPerChunk = 16;  // MMA k-steps per chunk
constexpr int kMaxK = 4;
constexpr int kStages = 2;          // ring slots of one chunk each
constexpr int kListCap = kPassRows * kMaxK;  // chunks one pass can select
constexpr int kGroup = 8;  // passes whose lists are built together
constexpr int kRedLd = kRow + 8;  // floats per row of the k-order sums, padded
constexpr int kMaxMaskWords = 512;  // larger tables walk every chunk
constexpr uint32_t kOneF32 = 0x3f800000u;  // 1.0f, also 1.0 in TF32
constexpr uint32_t kOneBf16 = 0x3f80u;     // 1.0 in bf16
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStages >= 2, "a slot to load into while one is read");

template <bool kBf16>
struct Tile {
  static constexpr int kStep = kBf16 ? 16 : 8;  // MMA k
  static constexpr int kChunkRows = kStep * kStepsPerChunk;
  static constexpr int kBoxCols = kBf16 ? 64 : 32;  // 128 bytes of a row
  static constexpr int kBoxes = kRow / kBoxCols;
  static constexpr int kBoxBytes = kChunkRows * 128;
  static constexpr int kSlotBytes = kBoxes * kBoxBytes;  // 64 KB at 16 k-steps
};

// Byte offset in a slot of the 16-byte piece `piece` (0-7) of row `row` of
// box `box`: the 128-byte swizzle stores piece p of row r at p ^ (r % 8).
template <bool kBf16>
__device__ __forceinline__ int swizzled(int box, int row, int piece) {
  return box * Tile<kBf16>::kBoxBytes + row * 128 + ((piece ^ (row & 7)) << 4);
}

// bf16 pair (cols c, c + 1) of a one-hot row whose hot column is c + rel
__device__ __forceinline__ uint32_t onehot_pair(int rel) {
  return rel == 0 ? kOneBf16 : (rel == 1 ? (kOneBf16 << 16) : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed; traps
// (a launch error, never a hang) after 2^24 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The box of `map` at (column c0, row c1, bm c2) into shared memory, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar))
      : "memory");
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(row)));
}

// The shared state of a block, after the ring of stages.
struct Shared {
  uint64_t full[kStages];   // a slot's rows have landed
  uint64_t empty[kStages];  // every warp is done with a slot
  // the chunks each pass selects, ascending, at pass % (2 kGroup): the lists
  // of the group being walked and of the group after it
  int list[2 * kGroup][kListCap];
  int count[2 * kGroup];
  int walk_all;  // the block walks every chunk, without lists
  alignas(16) float red[kWarps / 4][16][kRedLd];  // a row block's sum over k, in k order
  uint32_t mask[1];  // kGroup x n_words bitmask words (a flexible tail)
};

// idx[bm, k, q] where it lies in [0, S), else -1 (also past QP)
__device__ __forceinline__ int index_at(const int* ix, int QP, int S, int k, int q) {
  const int s = q < QP ? __ldg(ix + (long long)k * QP + q) : -1;
  return (unsigned)s < (unsigned)S ? s : -1;
}

// Lists the chunks that each pass of the group starting at pass p0 selects
// (the chunks its 64 x K indices fall in) into sh.list[pass % (2 kGroup)]:
// every thread marks K indices in the pass's bitmask, then warp w compacts
// pass p0 + w's mask in chunk order and clears it. Two block barriers for
// kGroup passes; every thread calls it.
template <int kChunkRows, int K>
__device__ void select_group(Shared& sh, const int* ix, int QP, int S, int q_block, int p0,
                             int n_pass, int n_words, int tid) {
  constexpr int kPerGroup = kGroup * kPassRows * K;
  static_assert(kPerGroup % kThreads == 0, "whole rounds of the block");
  int s[kPerGroup / kThreads];
#pragma unroll
  for (int i = 0; i < kPerGroup / kThreads; ++i) {  // all loads before any atomic
    const int f = tid + i * kThreads, gp = f / (kPassRows * K);
    const int k = f / kPassRows % K, q = f % kPassRows;
    s[i] = p0 + gp < n_pass ? index_at(ix, QP, S, k, q_block + (p0 + gp) * kPassRows + q) : -1;
  }
#pragma unroll
  for (int i = 0; i < kPerGroup / kThreads; ++i) {
    if (s[i] < 0) continue;
    const int gp = (tid + i * kThreads) / (kPassRows * K), c = s[i] / kChunkRows;
    atomicOr(&sh.mask[gp * n_words + (c >> 5)], 1u << (c & 31));
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, pass = p0 + warp;
  if (warp < kGroup && pass < n_pass) {
    uint32_t* mask = sh.mask + warp * n_words;
    int* list = sh.list[pass % (2 * kGroup)];
    int base = 0;
    for (int w0 = 0; w0 < n_words; w0 += 32) {
      uint32_t bits = 0u;
      if (w0 + lane < n_words) {
        bits = mask[w0 + lane];
        mask[w0 + lane] = 0u;
      }
      const int n = __popc(bits);
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      int at = base + incl - n;
      while (bits) {
        list[at++] = (w0 + lane) * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
      }
      base += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) sh.count[pass % (2 * kGroup)] = base;
  }
  __syncthreads();
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) for `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <bool kBf16, int K>
__global__ void __launch_bounds__(kThreads, 1)
gather_onehot_kernel(const __grid_constant__ CUtensorMap table_map,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int S, int QP, int qt, int n_words) {
  using T = Tile<kBf16>;
  constexpr int kStep = T::kStep, kChunkRows = T::kChunkRows;
  static_assert(kStepsPerChunk <= 32, "a warp's hit k-steps in one word");
  // a row block's 4 warps split its K products: each k has kWarpsPerK warps,
  // which split the 128 channels into kTiles MMA tiles of 8 each (K = 3
  // leaves one warp of each row block idle)
  constexpr int kWarpsPerK = K == 3 ? 1 : 4 / K;
  constexpr int kTiles = kRow / 8 / kWarpsPerK;
  extern __shared__ __align__(128) unsigned char smem[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  Shared& sh = *reinterpret_cast<Shared*>(ring + kStages * T::kSlotBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int rb = warp >> 2;               // row block: 16 queries of a pass
  const int kw = (warp & 3) / kWarpsPerK;  // this warp's k (K: idle)
  const int col0 = (warp & 3) % kWarpsPerK * kTiles * 8;
  const int bm = blockIdx.y;
  const int* ix = idx + (long long)bm * K * QP;
  float* o = out + (long long)bm * QP * kRow;
  const int q_block = blockIdx.x * qt;
  const int n_pass = (min(qt, QP - q_block) + kPassRows - 1) / kPassRows;
  const int n_chunks = (S + kChunkRows - 1) / kChunkRows;

  for (int w = tid; w < kGroup * n_words; w += kThreads) sh.mask[w] = 0u;

  // The walk: the chunks each pass selects, or every chunk when the block's
  // first pass alone selects nearly all of them (random addresses, where
  // lists cost more than they save). Warp 0 decides, with no atomics and
  // no barrier of its own: it sets bit c % 32 for each chunk c that the
  // pass's 64 x K indices fall in, and the block walks every chunk when at
  // least 15/16 of min(n_chunks, 32) bits are set (exact up to 32 chunks).
  if (warp == 0) {
    uint32_t seen = 0u;
#pragma unroll
    for (int i = 0; i < kPassRows * K / 32; ++i) {
      const int f = lane + 32 * i;
      const int s = index_at(ix, QP, S, f / kPassRows, q_block + f % kPassRows);
      if (s >= 0) seen |= 1u << ((s / kChunkRows) & 31);
    }
    const int n_seen = __popc(__reduce_or_sync(kFull, seen));
    if (lane == 0) sh.walk_all = n_words == 0 || 16 * n_seen >= 15 * min(n_chunks, 32);
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sh.full[i], 1);
      mbar_init(&sh.empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool selecting = !sh.walk_all;
  if (selecting) select_group<kChunkRows, K>(sh, ix, QP, S, q_block, 0, n_pass, n_words, tid);

  auto next_group = [&](int pass) {
    const int group_end = (pass / kGroup + 1) * kGroup;  // first pass of the next group
    if (selecting && pass % kGroup == 0 && group_end < n_pass)
      select_group<kChunkRows, K>(sh, ix, QP, S, q_block, group_end, n_pass, n_words, tid);
    return group_end + kGroup - 1;  // the last pass with a list
  };

  // thread 0 loads: the items are every pass's chunks in walk order. Its
  // position (p_pass, p_pos) moves to the next pass as soon as it has loaded
  // a pass's last chunk, so it never reads a pass's list after the list has
  // been rebuilt for a later pass. A slot is loaded again once every warp
  // has released it.
  int p_pass = 0, p_pos = 0, p_issued = 0;
  auto produce = [&](int target, int avail_pass) {
    while (p_issued < target && p_pass < n_pass && p_pass <= avail_pass) {
      const int cnt = selecting ? sh.count[p_pass % (2 * kGroup)] : n_chunks;
      if (p_pos < cnt) {
        const int chunk = selecting ? sh.list[p_pass % (2 * kGroup)][p_pos] : p_pos;
        const int slot = p_issued % kStages, round = p_issued / kStages;
        if (round > 0) mbar_wait(&sh.empty[slot], (round - 1) & 1);
        // the whole box counts, rows past S included (filled with zeros)
        mbar_arrive_expect_tx(&sh.full[slot], T::kSlotBytes);
        for (int box = 0; box < T::kBoxes; ++box)
          tma_load(ring + slot * T::kSlotBytes + box * T::kBoxBytes, &table_map,
                   box * T::kBoxCols, chunk * kChunkRows, bm, &sh.full[slot]);
        ++p_pos;
        ++p_issued;
      }
      if (p_pos >= cnt) {
        ++p_pass;
        p_pos = 0;
      }
    }
  };

  // A warp's own indices (its k, rows g and g + 8) are loaded a pass ahead
  // of their use, so that their latency hides behind a pass of products.
  const int k_ld = min(kw, K - 1);  // an idle warp loads and never uses
  int n0 = index_at(ix, QP, S, k_ld, q_block + rb * 16 + g);
  int n1 = index_at(ix, QP, S, k_ld, q_block + rb * 16 + g + 8);

  int item = 0;  // items this warp has consumed
  for (int pass = 0; pass < n_pass; ++pass) {
    const int q_pass = q_block + pass * kPassRows;
    const int r0 = q_pass + rb * 16 + g, r1 = r0 + 8;
    const int i0 = kw < K ? n0 : -1, i1 = kw < K ? n1 : -1;
    n0 = index_at(ix, QP, S, k_ld, r0 + kPassRows);
    n1 = index_at(ix, QP, S, k_ld, r1 + kPassRows);
    const int avail = next_group(pass);
    if (tid == 0) produce(item + kStages, avail);

    float acc[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    const int cnt = selecting ? sh.count[pass % (2 * kGroup)] : n_chunks;
    for (int pos = 0; pos < cnt; ++pos, ++item) {
      if (tid == 0) produce(item + kStages, avail);
      const int chunk = selecting ? sh.list[pass % (2 * kGroup)][pos] : pos;
      const int s_chunk = chunk * kChunkRows;
      // bit ks: a row of this warp selects a row of k-step ks
      const int d0 = i0 - s_chunk, d1 = i1 - s_chunk;
      uint32_t bits = 0u;
      if ((unsigned)d0 < (unsigned)kChunkRows) bits |= 1u << (d0 / kStep);
      if ((unsigned)d1 < (unsigned)kChunkRows) bits |= 1u << (d1 / kStep);
      uint32_t steps = __reduce_or_sync(kFull, bits);
      const int slot = item % kStages;
      mbar_wait(&sh.full[slot], (item / kStages) & 1);
      const unsigned char* stage = ring + slot * T::kSlotBytes;

      // the hit k-steps one at a time (uniform across the warp): every other
      // fragment of the chunk has an all-zero A
      while (steps) {
        const int ks = __ffs(steps) - 1;
        steps &= steps - 1u;
        const int s_base = s_chunk + ks * kStep;
        uint32_t a[4];
        if (kBf16) {
          // a0: (g, 2t..2t+1), a1: (g+8, 2t..), a2: (g, 2t+8..), a3: (g+8, 2t+8..)
          const int rel0 = i0 - s_base - 2 * t, rel1 = i1 - s_base - 2 * t;
          a[0] = onehot_pair(rel0);
          a[1] = onehot_pair(rel1);
          a[2] = onehot_pair(rel0 - 8);
          a[3] = onehot_pair(rel1 - 8);
#pragma unroll
          for (int jj = 0; jj < kTiles; jj += 2) {
            // B fragments (k row pairs 2t, 2t + 8; column col0 + j * 8 + g)
            // of tiles jj and jj + 1: matrix lane / 8 is k rows +0 / +8 of
            // tile jj, then of jj + 1; a tile is one 16-byte piece of a
            // 64-column box
            const int m = lane >> 3;
            const int krow = ks * kStep + (m & 1) * 8 + (lane & 7);
            const int col = col0 + (jj + (m >> 1)) * 8;
            uint32_t d[4];
            ldmatrix_x4_trans(d, stage + swizzled<kBf16>(col >> 6, krow, (col & 63) >> 3));
            mma_bf16(acc[jj], a, d[0], d[1]);
            mma_bf16(acc[jj + 1], a, d[2], d[3]);
          }
        } else {
          // a0: (g, t), a1: (g+8, t), a2: (g, t+4), a3: (g+8, t+4)
          const int rel0 = i0 - s_base - t, rel1 = i1 - s_base - t;
          a[0] = rel0 == 0 ? kOneF32 : 0u;
          a[1] = rel1 == 0 ? kOneF32 : 0u;
          a[2] = rel0 == 4 ? kOneF32 : 0u;
          a[3] = rel1 == 4 ? kOneF32 : 0u;
          const int row = ks * kStep + t;
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            // B fragment (k rows t, t + 4; column n = col0 + j * 8 + g): word
            // g % 4 of piece (n % 32) / 4 of box n / 32
            const int n = col0 + j * 8 + g;
            const int box = n >> 5, piece = (n & 31) >> 2, word = 4 * (g & 3);
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(stage + swizzled<kBf16>(box, row, piece) + word);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
                stage + swizzled<kBf16>(box, row + 4, piece) + word);
            mma_tf32(acc[j], a, b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sh.empty[slot]);
    }

    // The row block's K accumulators, added in k order through shared
    // memory: ((t_0 + t_1) + t_2) + ..., the last k writing the output.
    // Accumulator (c0, c1) is row g, columns 2t, 2t + 1 of its tile; (c2, c3)
    // row g + 8.
    float* red = &sh.red[rb][0][0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (kw == k) {
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const int n = col0 + j * 8 + 2 * t;
          float2 v0 = make_float2(acc[j][0], acc[j][1]), v1 = make_float2(acc[j][2], acc[j][3]);
          float2* p0 = reinterpret_cast<float2*>(red + g * kRedLd + n);
          float2* p1 = reinterpret_cast<float2*>(red + (g + 8) * kRedLd + n);
          if (k > 0) {
            const float2 u0 = *p0, u1 = *p1;
            v0 = make_float2(u0.x + v0.x, u0.y + v0.y);
            v1 = make_float2(u1.x + v1.x, u1.y + v1.y);
          }
          if (k < K - 1) {
            *p0 = v0;
            *p1 = v1;
          } else {
            if (r0 < QP) __stcs(reinterpret_cast<float2*>(o + (long long)r0 * kRow + n), v0);
            if (r1 < QP) __stcs(reinterpret_cast<float2*>(o + (long long)r1 * kRow + n), v1);
          }
        }
      }
      // the row block's 4 warps: each k waits for the one before, and the
      // next pass's first k for this pass's last
      if (K > 1) named_barrier(1 + rb, 128);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime API
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool kBf16, int K>
int launch_k(const void* table, const int* idx, float* out, int BM, int S, int QP,
             int qt, cudaStream_t st) {
  using T = Tile<kBf16>;
  // table (BM, S, 128) as a 3-D map, innermost first; a box is 128 bytes of
  // a chunk's rows, rows past S read as zeros
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int esize = kBf16 ? 2 : 4;
  const cuuint64_t dims[3] = {kRow, (cuuint64_t)S, (cuuint64_t)BM};
  const cuuint64_t strides[2] = {(cuuint64_t)kRow * esize, (cuuint64_t)S * kRow * esize};
  const cuuint32_t box[3] = {T::kBoxCols, T::kChunkRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap map;
  if (encode(&map, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(table), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = ((long long)S + T::kChunkRows - 1) / T::kChunkRows;
  const int words = (int)((n_chunks + 31) / 32);
  const int n_words = words <= kMaxMaskWords ? words : 0;
  const size_t smem =
      1024 + kStages * T::kSlotBytes + sizeof(Shared) + 4 * (size_t)kGroup * n_words;
  auto kernel = gather_onehot_kernel<kBf16, K>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((QP + qt - 1) / qt), (unsigned)BM);
  kernel<<<grid, kThreads, smem, st>>>(map, idx, out, S, QP, qt, n_words);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch(const void* table, const int* idx, float* out, int BM, int S,
           int K, int QP, int qt, void* stream) {
  if (BM < 0 || BM > 65535 || S < 1 || K < 1 || K > kMaxK || QP < 0 ||
      qt < kPassRows || qt % kPassRows != 0)
    return (int)cudaErrorInvalidValue;
  if (BM == 0 || QP == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_k<kBf16, 1>(table, idx, out, BM, S, QP, qt, st);
    case 2: return launch_k<kBf16, 2>(table, idx, out, BM, S, QP, qt, st);
    case 3: return launch_k<kBf16, 3>(table, idx, out, BM, S, QP, qt, st);
    default: return launch_k<kBf16, 4>(table, idx, out, BM, S, QP, qt, st);
  }
}

}  // namespace

// table (BM, S, 128) f32 or bf16, idx (BM, K, QP) int32, out (BM, QP, 128)
// f32: contiguous, on the device. 1 <= K <= 4; qt, the queries of one block,
// a multiple of 64. Launches on `stream` and returns cudaGetLastError().
extern "C" int gather_onehot_f32(const void* table, const int* idx, float* out,
                                 int BM, int S, int K, int QP, int qt,
                                 void* stream) {
  return launch<false>(table, idx, out, BM, S, K, QP, qt, stream);
}

extern "C" int gather_onehot_bf16(const void* table, const int* idx,
                                  float* out, int BM, int S, int K, int QP,
                                  int qt, void* stream) {
  return launch<true>(table, idx, out, BM, S, K, QP, qt, stream);
}
