// Windowed top-k attention for label propagation (K1 to K5), for sm_90a.
//
// Replaces the Pallas TPU kernel fgvc_tpu/ops/pallas/topk_attention.py
// (_make_kernel, launched by _call_fused_kernel) behind both of its entries,
// as there: one kernel, two entries, and the row-block mode of the banked
// entry.
//   K1  fused_topk_attention_banked: keys come from a bank normalised and
//       halo-padded once per video (TAP-Vid points: circle mask; DAVIS VOS
//       masks: square mask).
//   K2  fused_topk_attention: the caller hands raw (T, H, W, C) keys that
//       the wrapper normalises and halo-pads into the same bank geometry on
//       every call (the save_mem streaming scan of DAVIS VOS, square mask).
//   K4  the row-block mode of the banked entry (spatial-parallel
//       propagation, `row0` / `grid_rows` of the Pallas kernel): the query
//       is one block of hb rows of a grid over-padded to grid_rows rows,
//       whose first row is the global row `row0`; the bank is over-padded
//       to match.  Query, scratch and output rows are local to the block;
//       bank rows, the in-image test and value rows are global.  Block rows
//       at or past H are not computed (the wrapper zeroes the output).
//       Every (query, key) pair is summed in the same order wherever its
//       tile lies, so the blocks assemble to the unsharded result bit for
//       bit.
//   K5  the profiling cut-downs of the unbanked entry (`debug_passes` of
//       the Pallas kernel, :229-233 and :324-333, which
//       tools/bench/pass_breakdown.py times): 'a' runs affinity_kernel and
//       a small emit kernel that writes slot 0's affinities in the Pallas
//       column layout; 'ab' runs select_kernel up to pass B's statistics
//       and writes them.  A template parameter (PASSES) of launch and
//       select_kernel, one extern "C" entry per mode
//       (fgvc_topk_attention_<mode>_cut); the 'abc' code is unchanged.  On
//       this card pass A is affinity_kernel, and passes B and C share
//       select_kernel: B is the per-lane lists and the warp merge, C the
//       rescan and the value gather.  Their bound is pass A's (the live
//       products), as for K2.
// The wrappers (fgvc_tpu_torch/ops/cuda/topk_attention.py) do the padding;
// this file sees a padded bank either way.
//
// K3 is the kernel's compute mode (`compute_dtype` of the Pallas kernel, a
// template parameter here, one extern "C" entry per mode):
//   'float32'   (fgvc_topk_attention_f32) f32 query, bank and values; q.k as
//               3xTF32 on the tensor cores (x = big + small, both tf32,
//               q.k = small.big + big.small + big.big in f32, about 2^-21 of
//               each product kept), the card's counterpart of the Pallas
//               Precision.HIGHEST matmul; the value mix in f32 FMAs.
//   'high'      (fgvc_topk_attention_high) f32 operands, each split as
//               x = hi + lo with hi = bf16(x), lo = bf16(x - hi), both rounded
//               to nearest even; q.k = sum hi.hi + hi.lo + lo.hi (no lo.lo),
//               and the value mix sum w_hi.v_hi + w_hi.v_lo + w_lo.v_hi: the
//               Pallas manual bf16x3 (_make_kernel :114-121, :192-199,
//               :366-391).  Three bf16 tensor-core products instead of one.
//   'bfloat16'  (fgvc_topk_attention_bf16) the query and the bank are bf16
//               (normalised in f32, then rounded by the wrapper); q.k sums
//               bf16 x bf16 products in f32 on the tensor cores, and the value
//               mix sums bf16(w) x bf16(v) in f32, with w computed in f32 and
//               the values handed over in f32 and rounded here (:201-214,
//               :353-365, :611-614).
// A product of two bf16 values is exact in f32, so in 'high' and 'bfloat16'
// only the order of the f32 sums differs from another implementation; the
// tensor cores' order cannot be repeated in PyTorch, so the plain versions
// agree with this kernel to rounding, and a row whose k-th largest affinity
// lies within rounding of the next may select another member.  Within the
// kernel each (query, key) pair is summed by one instruction sequence
// wherever it lies, so a frame in two slots ties exactly and row blocks (K4)
// equal the unsharded result bit for bit.  Masks, the top-k statistics and
// the tie split are the same in every mode.
//
// What it computes, for every query pixel of a (Hp, Wp) grid cut into
// tile x tile query tiles:
//   a[t, wi, wj] = (q . k[frame_idx[t], r0 + wi, c0 + wj]) / temperature
//                  + NEG * [outside the radius window]
//                  + NEG * [key outside the image] + frame_bias[t]
// over the win x win halo window (win = tile + 2 * halo) of each of the T key
// slots, then the exact top-k statistics of the Pallas kernel (threshold =
// k-th largest element, count above, count at the threshold, fractional
// share of the tied candidates, max, normaliser z) and
//   out = sum_keys exp(min(a - max, 0)) * ([a > thr] + frac * [a == thr]) * v / z.
// The radius window is the strict circle dy^2 + dx^2 < r^2, or with
// `square` set the inclusive square |dy| <= r && |dx| <= r, the Pallas rule
// in the same float arithmetic.  Rows with fewer than k live keys take every
// live key once; an all-masked row gives 0.  NEG = -1e30 marks a masked key;
// values <= NEG / 2 are dead.
//
// Design.  The Pallas kernel keeps the whole (tile^2, T * win^2) affinity of a
// query tile in VMEM (14 MB at the DAVIS shapes).  A Hopper block has at most
// 227 KB of shared memory, so this port writes the masked affinities of all
// query tiles to a global scratch buffer that the wrapper allocates
// (ntiles * tile^2 * T * win^2 floats: 832 MB for 128 x 128 TAP-Vid
// features, 5.46 GB for 240 x 440 DAVIS VOS features; a K4 row block's
// covers its own tiles only, 2.91 GB for half of the VOS rows), then runs
// one warp per query row over it:
//   1. affinity_kernel: a tensor-core product (mma.sync, 128 queries x 128
//      keys per block, operands staged by cp.async and split once in shared
//      memory; see the kernel), with the masks computed from coordinates in
//      the epilogue and all-masked fragments not multiplied.
//   2. select_kernel: each lane keeps the exact top distinct values of its
//      strided share of the row with their counts (enough entries to reach k
//      elements); the warp merges the 32 lists by distinct-value rounds,
//      which gives the same statistics as the Pallas kernel's pass B.  The
//      value mix is k-sparse, so instead of a dense weight x value product
//      the warp rescans its row for the keys at or above the threshold and
//      gathers their value vectors, one channel per lane.
//
// What bounds it on an H100.  At the TAP-Vid shapes (128 x 128 queries, T =
// 6, radius 15, circle, C = 256) the live (in-window, in-image, valid-slot)
// pairs need 31.69 GFLOP per call and the dense halo windows 106.50 GFLOP; at
// the DAVIS VOS shapes (240 x 440 queries, square) 296.39 and 698.92 GFLOP.
// affinity_kernel multiplies the windows' fragments that hold a live pair,
// so its floor is the dense product at the mode's tensor-core rate (989
// TFLOP/s bf16, 495 TF32, published peaks at 700 W): TAP-Vid 'bfloat16'
// 0.108 ms, 'high' (three products) 0.323 ms, 'float32' (3xTF32) 0.645 ms;
// VOS 0.707, 2.12 and 4.24 ms; and the scratch write beside it, 832 MB in
// 0.248 ms (TAP-Vid), 5.46 GB in 1.63 ms (VOS) at 3.35 TB/s.  select_kernel
// reads the scratch twice (1.66 GB, 0.50 ms at TAP-Vid shapes) and is
// latency bound: one warp's serial list inserts per query row.  Keeping the
// affinities on chip is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FGVC_MAX_T 16

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// compute modes (K3)
constexpr int MODE_F32 = 0;
constexpr int MODE_HIGH = 1;
constexpr int MODE_BF16 = 2;

// the query and bank element type of a mode
template <int MODE>
struct Operand {
  using T = float;
};
template <>
struct Operand<MODE_BF16> {
  using T = __nv_bfloat16;
};

// bf16(x) back in f32, rounded to nearest even (jnp's astype(bfloat16))
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one weighted value added to an accumulator in the mode's arithmetic
template <int MODE>
__device__ __forceinline__ float mix(float w, float v, float acc) {
  if (MODE == MODE_BF16) return fmaf(bf16_round(w), bf16_round(v), acc);
  if (MODE == MODE_HIGH) {
    const float wh = bf16_round(w), wl = bf16_round(w - wh);
    const float vh = bf16_round(v), vl = bf16_round(v - vh);
    acc = fmaf(wh, vh, acc);
    acc = fmaf(wh, vl, acc);
    return fmaf(wl, vh, acc);
  }
  return fmaf(w, v, acc);
}

}  // namespace

// Passed by value from the host (ctypes mirrors this layout field by field).
struct TopkAttnParams {
  int H, W;                // query / value image size
  int Hp, Wp;              // query grid (K4: the block's rows) padded to
                           // a multiple of tile
  int row0;                // global row of the first query row (K4; else 0)
  int C;                   // feature channels (multiple of 16)
  int Cv;                  // value channels
  int T;                   // key slots
  int tile, halo, win;     // query tile edge, halo, window edge
  int rows_total, cols_total;  // padded bank geometry
  int topk;
  int square;              // 1: square radius window, 0: circle
  float inv_temp;          // 1 / temperature
  float rr;                // radius * radius
  float radius;
  int frame_idx[FGVC_MAX_T];     // bank frame of each key slot
  float frame_bias[FGVC_MAX_T];  // 0 for a valid slot, NEG otherwise
};

// The affinity product on the tensor cores (pass A).  One block computes the
// masked affinities of ABM = 128 queries of one query tile against ABN = 128
// keys (flat window columns f = wi * win + wj) of one key slot: 8 warps, each
// a 64 x 32 tile of 4 x 4 mma.sync fragments.  The channels stream through a
// ring of NSTAGE shared-memory stages filled by cp.async (16 bytes a copy),
// each holding KW words of every query and key row (Tiling below), with the
// stages after the current one in flight.  In 'float32' and 'high' each
// staged element is split once, one stage ahead of its products, into one
// of two split buffers that the fragments read, so a stage's split overlaps
// the previous stage's products and the block meets one barrier a stage:
//   'float32'  3xTF32: big = tf32(x), small = tf32(x - big) (cvt.rna), and
//              q.k += small.big, big.small, big.big per m16n8k8 step;
//   'high'     bf16x3: hi = bf16(x), lo = bf16(x - hi), and q.k += lo.hi,
//              hi.lo, hi.hi per m16n8k16 step (each product exact in f32);
//   'bfloat16' the bf16 operands as staged, one m16n8k16 product per step.
// Each output element is one accumulator register of one warp, summed over
// the channel steps from channel 0 in the same order with the same fragment
// role wherever its (query, key) pair lies: in every slot, tile, block and
// row block alike.  A fragment whose 16 x 8 pairs are all masked (outside
// the radius window or the image, or an invalid slot) is not multiplied: its
// entries are NEG-biased, and NEG swallows any product, so the values
// written are the same bit for bit.  The block's output tile goes through
// shared memory and out in rows of 512 contiguous bytes.
namespace {

constexpr int ABM = 128;              // queries per affinity block
constexpr int ABN = 128;              // keys per affinity block
constexpr int AROWS = ABM + ABN;      // staged rows: queries, then keys
constexpr int NSTAGE = 3;
constexpr int LDO = ABN + 4;          // row stride of the output tile
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int MI = WM / 16, NI = WN / 8;

// A mode's stages: KW words of each row per stage (f32: 8 channels, one k8
// step; 'high': 16 channels, split into 8 words of bf16 hi and of lo, one k16
// step; bf16: 32 channels, two k16 steps).  Rows that fragments read are
// padded by 4 words, so that a fragment read (8 rows x 4 words) hits 32
// banks: the bf16 stages and the split buffers (8 words a row); the raw
// stages of the split modes are read row by row and are not padded.
template <int MODE>
struct Tiling {
  static constexpr bool SPLIT = MODE != MODE_BF16;
  static constexpr int KW = MODE == MODE_F32 ? 8 : 16;
  static constexpr int LDR = SPLIT ? KW : KW + 4;  // raw row stride (words)
  static constexpr int CH = MODE == MODE_BF16 ? 2 * KW : KW;  // channels a stage
  static constexpr int LDS = 12;                   // split row stride (words)
  static constexpr int RAW_WORDS = AROWS * LDR;    // one ring stage
  static constexpr int HALF_WORDS = AROWS * LDS;   // big (hi) or small (lo)
  static constexpr int OPERAND_WORDS = NSTAGE * RAW_WORDS + (SPLIT ? 4 * HALF_WORDS : 0);
  static constexpr int SMEM_BYTES =
      4 * (OPERAND_WORDS > ABM * LDO ? OPERAND_WORDS : ABM * LDO);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo_k)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi_k)) << 16);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragments of one step at word w0 of rows of stride LD: the m16 A
// fragment of rows m0.. (words w0 + tig and w0 + tig + 4 of rows gid and
// gid + 8) and the n8 B fragment of rows n0.. (words w0 + tig, w0 + tig + 4
// of row gid).  The same words serve m16n8k8 tf32 (one channel a word) and
// m16n8k16 bf16 (two).
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint32_t* X, int m0, int w0,
                                       int gid, int tig) {
  const uint32_t* r0 = X + (m0 + gid) * LD + w0 + tig;
  const uint32_t* r8 = r0 + 8 * LD;
  a[0] = r0[0];
  a[1] = r8[0];
  a[2] = r0[4];
  a[3] = r8[4];
}
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const uint32_t* X, int n0, int w0,
                                       int gid, int tig) {
  const uint32_t* r = X + (n0 + gid) * LD + w0 + tig;
  b[0] = r[0];
  b[1] = r[4];
}

// The Pallas kernel's masks of one (query, key) pair, in the same float
// arithmetic: 0, NEG or 2 NEG (strict circle or inclusive square, then the
// image-border strip).  qrow = (qi + halo, qj + halo) of the query; kcol =
// (wi, wj, key inside the image) of the key.
__device__ __forceinline__ float pair_bias(const TopkAttnParams& p, int2 qrow, int4 kcol) {
  const float dy = (float)(kcol.x - qrow.x);
  const float dx = (float)(kcol.y - qrow.y);
  const bool in_range = p.square ? (fabsf(dy) <= p.radius && fabsf(dx) <= p.radius)
                                 : __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) < p.rr;
  return __fadd_rn(in_range ? 0.f : NEG, kcol.z ? 0.f : NEG);
}

// Split one raw stage (AROWS rows of KW f32 words) into the big / small
// ('float32') or hi / lo ('high') halves at `half` and `half + HALF_WORDS`.
template <int MODE>
__device__ __forceinline__ void split_stage(const uint32_t* raw, uint32_t* half, int tid) {
  using TL = Tiling<MODE>;
#pragma unroll
  for (int n = 0; n < AROWS * TL::KW / 4 / THREADS; ++n) {
    const int i = tid + THREADS * n;
    const int row = i / (TL::KW / 4), quad = i % (TL::KW / 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + row * TL::LDR + quad * 4);
    if (MODE == MODE_F32) {
      uint4 big, small;
      big.x = to_tf32(x.x);
      big.y = to_tf32(x.y);
      big.z = to_tf32(x.z);
      big.w = to_tf32(x.w);
      small.x = to_tf32(x.x - __uint_as_float(big.x));
      small.y = to_tf32(x.y - __uint_as_float(big.y));
      small.z = to_tf32(x.z - __uint_as_float(big.z));
      small.w = to_tf32(x.w - __uint_as_float(big.w));
      *reinterpret_cast<uint4*>(half + row * TL::LDS + quad * 4) = big;
      *reinterpret_cast<uint4*>(half + TL::HALF_WORDS + row * TL::LDS + quad * 4) = small;
    } else {
      // channels 4 quad .. + 3 are words 2 quad, + 1 of a bf16 row
      const float hx = bf16_round(x.x), hy = bf16_round(x.y);
      const float hz = bf16_round(x.z), hw = bf16_round(x.w);
      *reinterpret_cast<uint2*>(half + row * TL::LDS + quad * 2) =
          make_uint2(pack_bf16(hx, hy), pack_bf16(hz, hw));
      *reinterpret_cast<uint2*>(half + TL::HALF_WORDS + row * TL::LDS + quad * 2) =
          make_uint2(pack_bf16(x.x - hx, x.y - hy), pack_bf16(x.z - hz, x.w - hw));
    }
  }
}

}  // namespace

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
affinity_kernel(const typename Operand<MODE>::T* __restrict__ q,
                const typename Operand<MODE>::T* __restrict__ bank,
                float* __restrict__ aff, const TopkAttnParams p) {
  using T = typename Operand<MODE>::T;
  using TL = Tiling<MODE>;
  constexpr int CHUNK = 16 / sizeof(T);  // channels of one 16-byte copy
  constexpr int PARTS = TL::KW / 4;      // 16-byte copies of a staged row
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const split = smem + NSTAGE * TL::RAW_WORDS;  // two (big, small) pairs

  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntw = p.Wp / p.tile;
  const int t = blockIdx.z % p.T;
  const int tile_id = blockIdx.z / p.T;
  const int r0 = (tile_id / ntw) * p.tile;
  const int c0 = (tile_id % ntw) * p.tile;
  const int s0 = blockIdx.y * ABM;
  const int f0 = blockIdx.x * ABN;
  const bool slot_ok = p.frame_bias[t] == 0.f;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * WM, wn = (warp >> 1) * WN;

  // each thread copies 16 bytes (piece `part`) of its rows: query rows
  // (local to the block) first, then key rows (global bank rows)
  constexpr int RPT = AROWS * PARTS / THREADS;  // rows per thread
  const int part = tid % PARTS;
  const T* src[RPT];
  bool ok[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = tid / PARTS + (THREADS / PARTS) * j;
    src[j] = q;
    if (row < ABM) {
      const int s = s0 + row;
      ok[j] = s < S;
      if (ok[j]) src[j] = q + ((size_t)(r0 + s / p.tile) * p.Wp + (c0 + s % p.tile)) * p.C;
    } else {
      const int f = f0 + row - ABM;
      ok[j] = f < FK;
      if (ok[j])
        src[j] = bank + (((size_t)p.frame_idx[t] * p.rows_total + p.row0 + r0 + f / p.win) *
                             p.cols_total + (c0 + f % p.win)) * p.C;
    }
  }
  const int nk = (p.C + TL::CH - 1) / TL::CH;
  auto load = [&](int kc) {
    uint32_t* dst = smem + (kc % NSTAGE) * TL::RAW_WORDS;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = tid / PARTS + (THREADS / PARTS) * j;
      const int c = kc * TL::CH + part * CHUNK;
      const bool in = ok[j] && c < p.C;
      cp_async16(dst + row * TL::LDR + part * 4, src[j] + (in ? c : 0), in);
    }
  };
  // the first stages fly while the masks are worked out
  constexpr int AHEAD = TL::SPLIT ? NSTAGE : NSTAGE - 1;
  if (slot_ok) {
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
  }

  // The block's query rows and key columns: qrow[i] = (qi + halo, qj +
  // halo) of query s0 + i, kcol[j] = (wi, wj, key in the image, f < FK) of
  // key f0 + j.
  __shared__ int2 qrow[ABM];
  __shared__ int4 kcol[ABN];
  if (tid < ABM) {
    const int s = s0 + tid;
    qrow[tid] = make_int2(s / p.tile + p.halo, s % p.tile + p.halo);
  } else {
    const int f = f0 + tid - ABM;
    const int wi = f / p.win, wj = f % p.win;
    const int kgi = p.row0 + r0 + wi - p.halo, kgj = c0 + wj - p.halo;
    kcol[tid - ABM] = make_int4(wi, wj, kgi >= 0 && kgi < p.H && kgj >= 0 && kgj < p.W, f < FK);
  }
  __syncthreads();

  // Live fragments of this warp: bit mi * NI + ni is set where some pair of
  // the fragment is unmasked; each lane tests the 2 x 2 pairs whose
  // accumulators it holds.
  unsigned live = 0;
  if (slot_ok) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        bool any = false;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = wm + mi * 16 + gid + 8 * h, j = wn + ni * 8 + 2 * tig + e;
            const int4 kc = kcol[j];
            any |= s0 + i < S && kc.w && pair_bias(p, qrow[i], kc) == 0.f;
          }
        if (__any_sync(FULL, any)) live |= 1u << (mi * NI + ni);
      }
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  if (__syncthreads_or(live != 0)) {
    if (TL::SPLIT) {  // stage 0 split before the loop
      cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      split_stage<MODE>(smem, split, tid);
    }
    for (int kc = 0; kc < nk; ++kc) {
      // split modes: stage kc + 1 landed, stage kc's split is visible, the
      // ring slot of stage kc and the split buffer of kc + 1 are free;
      // bf16: stage kc landed, the slot of stage kc - 1 is free
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      if (kc + AHEAD < nk) load(kc + AHEAD);
      cp_async_commit();
      const uint32_t* X;  // the operands of stage kc
      if (TL::SPLIT) {
        if (kc + 1 < nk)
          split_stage<MODE>(smem + ((kc + 1) % NSTAGE) * TL::RAW_WORDS,
                            split + ((kc + 1) % 2) * 2 * TL::HALF_WORDS, tid);
        X = split + (kc % 2) * 2 * TL::HALF_WORDS;
      } else {
        X = smem + (kc % NSTAGE) * TL::RAW_WORDS;
      }
      if (live) {
        constexpr int LD = TL::SPLIT ? TL::LDS : TL::LDR;
        const uint32_t* Y = X + ABM * LD;  // the key rows
        const uint32_t* XL = X + TL::HALF_WORDS;  // small / lo halves
        const uint32_t* YL = XL + ABM * LD;
        // 8 words a step: a tf32 k8 step or a bf16 k16 step
        constexpr int STEPS = TL::SPLIT ? 1 : TL::KW / 8;
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          const int w0 = 8 * st;
          uint32_t b[NI][2], bl[NI][2];
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            frag_b<LD>(b[ni], Y, wn + ni * 8, w0, gid, tig);
            if (TL::SPLIT) frag_b<LD>(bl[ni], YL, wn + ni * 8, w0, gid, tig);
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if (!((live >> (mi * NI)) & ((1u << NI) - 1))) continue;
            uint32_t a[4], al[4];
            frag_a<LD>(a, X, wm + mi * 16, w0, gid, tig);
            if (TL::SPLIT) frag_a<LD>(al, XL, wm + mi * 16, w0, gid, tig);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              if (!((live >> (mi * NI + ni)) & 1u)) continue;
              if (MODE == MODE_F32) {  // small.big, big.small, big.big
                mma_tf32(acc[mi][ni], al, b[ni]);
                mma_tf32(acc[mi][ni], a, bl[ni]);
                mma_tf32(acc[mi][ni], a, b[ni]);
              } else if (MODE == MODE_HIGH) {  // lo.hi, hi.lo, hi.hi
                mma_bf16(acc[mi][ni], al, b[ni]);
                mma_bf16(acc[mi][ni], a, bl[ni]);
                mma_bf16(acc[mi][ni], a, b[ni]);
              } else {
                mma_bf16(acc[mi][ni], a, b[ni]);
              }
            }
          }
        }
      }
    }
  }

  // Epilogue: (acc / temperature + masks) + slot bias, the Pallas order,
  // into an ABM x ABN tile in shared memory (over the operands), then each
  // warp writes whole rows of it, 512 contiguous bytes a row.
  cp_async_wait<0>();
  __syncthreads();
  float* const otile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm + mi * 16 + gid + 8 * h;
      const int2 qr = qrow[i];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = wn + ni * 8 + 2 * tig + e;
          otile[i * LDO + j] = __fadd_rn(__fadd_rn(__fmul_rn(acc[mi][ni][2 * h + e], p.inv_temp),
                                                   pair_bias(p, qr, kcol[j])),
                                         p.frame_bias[t]);
        }
    }
  __syncthreads();
  const size_t row_len = (size_t)p.T * FK;
  const int ncols = min(ABN, FK - f0);
  const bool vec = ncols == ABN && FK % 4 == 0;  // 16-byte aligned whole rows
  for (int i = warp; i < ABM && s0 + i < S; i += THREADS / 32) {
    float* out_row = aff + ((size_t)tile_id * S + s0 + i) * row_len + (size_t)t * FK + f0;
    const float* src_row = otile + i * LDO;
    if (vec) {
      reinterpret_cast<float4*>(out_row)[lane] = reinterpret_cast<const float4*>(src_row)[lane];
    } else {
      for (int j = lane; j < ncols; j += 32) out_row[j] = src_row[j];
    }
  }
}

// Per-lane list of the largest distinct values seen with their counts, cut
// after the entry at which the running count reaches k (KMAX > k).
template <int KMAX>
__device__ __forceinline__ void list_insert(float (&lv)[KMAX], int (&lc)[KMAX],
                                            float a, int k, float& cutoff) {
  bool found = false;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (lv[i] == a) {
      lc[i] += 1;
      found = true;
    }
  }
  if (!found) {
#pragma unroll
    for (int i = KMAX - 1; i > 0; --i) {
      if (lv[i - 1] < a) {
        lv[i] = lv[i - 1];
        lc[i] = lc[i - 1];
      } else if (lv[i] < a) {
        lv[i] = a;
        lc[i] = 1;
      }
    }
    if (lv[0] < a) {
      lv[0] = a;
      lc[0] = 1;
    }
  }
  int cum = 0;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (cum >= k) {
      lv[i] = -INFINITY;
      lc[i] = 0;
    } else {
      cum += lc[i];
      if (cum >= k) cutoff = lv[i];
    }
  }
}

// PASSES: 3 runs passes B and C ('abc'); 2 stops after pass B's statistics
// (K5 cut 'ab') and writes [thresh, mmax, z, frac, n_above, cnt_at] into
// channels 0..5 of the query pixel's output row, zeros into the rest (the
// first Cv of the six where Cv < 6), with no rescan and no gather.
template <int KMAX, int MODE, int PASSES = 3>
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ aff, const float* __restrict__ v,
              float* __restrict__ out, const TopkAttnParams p) {
  constexpr int NCH = 4;  // value channels per lane per pass (128 per warp)
  const int lane = threadIdx.x % 32;
  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntw = p.Wp / p.tile;
  const long long nq = (long long)(p.Hp / p.tile) * ntw * S;
  const long long g = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (g >= nq) return;  // uniform across the warp
  const int tile_id = (int)(g / S), s = (int)(g % S);
  const int r0 = (tile_id / ntw) * p.tile, c0 = (tile_id % ntw) * p.tile;
  const int gi = r0 + s / p.tile, gj = c0 + s % p.tile;  // gi: block row
  if (p.row0 + gi >= p.H || gj >= p.W) return;  // query-grid padding

  const int K = p.T * FK;
  const int k = p.topk;
  const float* row = aff + (size_t)g * K;

  // ---- exact top-k statistics: per-lane lists, then a warp merge ----
  float lv[KMAX];
  int lc[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    lv[i] = -INFINITY;
    lc[i] = 0;
  }
  float cutoff = -INFINITY;
  for (int j = lane; j < K; j += 32) {
    const float a = row[j];
    if (!(a > NEG * 0.5f) || a < cutoff) continue;
    list_insert<KMAX>(lv, lc, a, k, cutoff);
  }

  // Round r takes the largest distinct value below round r-1's across the
  // warp and its total count; every value down to the threshold is in some
  // lane's list with its exact count (a lane cuts only below its own k-th
  // element, which is at or below the row's k-th element).
  float prev = INFINITY, mmax = NEG, tv = NEG, zab = 0.f;
  int tc = 0, nab = 0, cum = 0;
  bool any = false;
  for (int r = 0; r < k; ++r) {
    float cand = -INFINITY;
    int cc = 0;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (lv[i] < prev && lv[i] > cand) {
        cand = lv[i];
        cc = lc[i];
      }
    }
    float vmax = cand;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, o));
    if (!(vmax > NEG * 0.5f)) break;  // no live value left: under-full row
    int c = (cand == vmax) ? cc : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
    if (!any) {
      mmax = vmax;
      any = true;
    } else {
      zab += expf(fminf(tv - mmax, 0.f)) * (float)tc;  // previous, above
    }
    tv = vmax;
    tc = c;
    nab = cum;
    cum += c;
    prev = vmax;
    if (cum >= k) break;
  }
  const float thresh = any ? tv : NEG;
  const float cnt_at = any ? (float)tc : 0.f;
  const float frac =
      fminf(fmaxf((float)k - (float)nab, 0.f), cnt_at) / fmaxf(cnt_at, 1.f);
  float z = zab;
  if (any) z += frac * cnt_at * expf(fminf(thresh - mmax, 0.f));
  z = fmaxf(z, 1e-30f);

  if constexpr (PASSES == 2) {
    // Pass B's max is the row's largest element, live or not (round 0 of
    // the Pallas rounds); a row with no live key needs a scan for it.
    float rmax = mmax;
    if (!any) {
      rmax = -INFINITY;
      for (int j = lane; j < K; j += 32) rmax = fmaxf(rmax, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, o));
    }
    const float stats[6] = {thresh, rmax, z, frac, (float)nab, cnt_at};
    float* op = out + ((size_t)gi * p.W + gj) * p.Cv;
    for (int ch = lane; ch < p.Cv; ch += 32) op[ch] = ch < 6 ? stats[ch] : 0.f;
    return;
  }

  // ---- value mix over the selected keys (k-sparse), in the mode's
  // arithmetic: w is computed in f32 and rounded per mode with v ----
  for (int cb = 0; cb < p.Cv; cb += 32 * NCH) {
    float acc[NCH];
#pragma unroll
    for (int n = 0; n < NCH; ++n) acc[n] = 0.f;
    if (any) {
      for (int j0 = 0; j0 < K; j0 += 32) {
        const int j = j0 + lane;
        const float a = j < K ? row[j] : NEG;
        unsigned mask = __ballot_sync(FULL, a > NEG * 0.5f && a >= thresh);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float as = __shfl_sync(FULL, a, src);
          const int js = j0 + src;
          const float w = expf(fminf(as - mmax, 0.f)) * (as > thresh ? 1.f : frac);
          const int t = js / FK, f = js % FK;
          // live keys lie in the image (global rows)
          const int vy = p.row0 + r0 + f / p.win - p.halo;
          const int vx = c0 + f % p.win - p.halo;
          const float* vp = v + (((size_t)t * p.H + vy) * p.W + vx) * p.Cv;
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            const int ch = cb + n * 32 + lane;
            if (ch < p.Cv) acc[n] = mix<MODE>(w, vp[ch], acc[n]);
          }
        }
      }
    }
    float* op = out + ((size_t)gi * p.W + gj) * p.Cv;
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const int ch = cb + n * 32 + lane;
      if (ch < p.Cv) op[ch] = acc[n] / z;
    }
  }
}

// K5 cut 'a' (pass A only): out[i, j, c] for c < Cv (<= wpad^2, which the
// wrapper checks) is column c of the query pixel's Pallas affinity row
// (aff_ref[:, :Pp] of _make_kernel), whose frame blocks are rows_pad x wpad
// with wpad = rows_pad = round_up(win, 8): slot 0, window row wi = c / wpad
// and column wj = c % wpad.  Inside the win x win window that is the
// scratch's column wi * win + wj; in the Pallas over-pad (wi or wj >= win)
// it is (NEG + border bias) + frame_bias[0], summed in the Pallas order
// (:134, :215), where the product term vanishes in NEG's rounding (|q.k| /
// temperature < 3.8e22).  One thread per output.
__global__ void __launch_bounds__(THREADS)
emit_affinity_kernel(const float* __restrict__ aff, float* __restrict__ out,
                     const TopkAttnParams p) {
  const long long n = (long long)p.H * p.W * p.Cv;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int c = (int)(idx % p.Cv);
  const int gj = (int)((idx / p.Cv) % p.W);
  const int gi = (int)(idx / ((long long)p.Cv * p.W));
  const int S = p.tile * p.tile;
  const int wpad = (p.win + 7) / 8 * 8;
  const int wi = c / wpad, wj = c % wpad;
  const int ntw = p.Wp / p.tile;
  const int r0 = (gi / p.tile) * p.tile, c0 = (gj / p.tile) * p.tile;
  float val;
  if (wi < p.win && wj < p.win) {
    const size_t g = (size_t)((gi / p.tile) * ntw + gj / p.tile) * S +
                     (gi % p.tile) * p.tile + gj % p.tile;
    val = aff[g * p.T * p.win * p.win + wi * p.win + wj];
  } else {
    const int kgi = p.row0 + r0 + wi - p.halo, kgj = c0 + wj - p.halo;
    const bool in_img = kgi >= 0 && kgi < p.H && kgj >= 0 && kgj < p.W;
    val = __fadd_rn(__fadd_rn(NEG, in_img ? 0.f : NEG), p.frame_bias[0]);
  }
  out[idx] = val;
}

// Launches the kernels of PASSES on `stream` (3: passes A, B and C; K5's
// profiling cut-downs 2: A and B's statistics, 1: A and the emit kernel);
// returns the CUDA error of the launches (0 on success).  q: (Hp, Wp, C);
// bank: (Tb, rows_total, cols_total, C), both f32, or bf16 in 'bfloat16';
// v: (T, H, W, Cv) f32; out: (H, W, Cv) f32, or (Hp, W, Cv) for a row block
// (K4); scratch: ntiles * tile^2 * T * win^2 f32 over the Hp x Wp query grid.
template <int MODE, int PASSES = 3>
int launch(const void* q, const void* bank, const float* v, float* out,
           float* scratch, const TopkAttnParams& p, cudaStream_t stream) {
  using T = typename Operand<MODE>::T;
  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntiles = (p.Hp / p.tile) * (p.Wp / p.tile);
  const dim3 grid_a((FK + ABN - 1) / ABN, (S + ABM - 1) / ABM, ntiles * p.T);
  constexpr int smem = Tiling<MODE>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(affinity_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  affinity_kernel<MODE><<<grid_a, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(bank), scratch, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (PASSES == 1) {
    const long long n = (long long)p.H * p.W * p.Cv;
    const int grid_e = (int)((n + THREADS - 1) / THREADS);
    emit_affinity_kernel<<<grid_e, THREADS, 0, stream>>>(scratch, out, p);
  } else {
    const long long nq = (long long)ntiles * S;
    const int grid_b = (int)((nq + THREADS / 32 - 1) / (THREADS / 32));
    if (p.topk < 16) {
      select_kernel<16, MODE, PASSES><<<grid_b, THREADS, 0, stream>>>(scratch, v, out, p);
    } else {
      select_kernel<32, MODE, PASSES><<<grid_b, THREADS, 0, stream>>>(scratch, v, out, p);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int fgvc_topk_attention_f32(const void* q, const void* bank,
                                       const float* v, float* out,
                                       float* scratch, TopkAttnParams p,
                                       cudaStream_t stream) {
  return launch<MODE_F32>(q, bank, v, out, scratch, p, stream);
}

extern "C" int fgvc_topk_attention_high(const void* q, const void* bank,
                                        const float* v, float* out,
                                        float* scratch, TopkAttnParams p,
                                        cudaStream_t stream) {
  return launch<MODE_HIGH>(q, bank, v, out, scratch, p, stream);
}

extern "C" int fgvc_topk_attention_bf16(const void* q, const void* bank,
                                        const float* v, float* out,
                                        float* scratch, TopkAttnParams p,
                                        cudaStream_t stream) {
  return launch<MODE_BF16>(q, bank, v, out, scratch, p, stream);
}

// K5: the profiling cut-downs of each mode; passes 1 ('a') or 2 ('ab').
template <int MODE>
int launch_cut(const void* q, const void* bank, const float* v, float* out,
               float* scratch, const TopkAttnParams& p, int passes,
               cudaStream_t stream) {
  if (passes == 1) return launch<MODE, 1>(q, bank, v, out, scratch, p, stream);
  if (passes == 2) return launch<MODE, 2>(q, bank, v, out, scratch, p, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fgvc_topk_attention_f32_cut(const void* q, const void* bank,
                                           const float* v, float* out,
                                           float* scratch, TopkAttnParams p,
                                           int passes, cudaStream_t stream) {
  return launch_cut<MODE_F32>(q, bank, v, out, scratch, p, passes, stream);
}

extern "C" int fgvc_topk_attention_high_cut(const void* q, const void* bank,
                                            const float* v, float* out,
                                            float* scratch, TopkAttnParams p,
                                            int passes, cudaStream_t stream) {
  return launch_cut<MODE_HIGH>(q, bank, v, out, scratch, p, passes, stream);
}

extern "C" int fgvc_topk_attention_bf16_cut(const void* q, const void* bank,
                                            const float* v, float* out,
                                            float* scratch, TopkAttnParams p,
                                            int passes, cudaStream_t stream) {
  return launch_cut<MODE_BF16>(q, bank, v, out, scratch, p, passes, stream);
}
