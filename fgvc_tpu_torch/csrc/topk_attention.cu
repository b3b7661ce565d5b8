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
//       select_kernel: B is the row's load, the candidates and the rounds,
//       C the selection and the value gather.  Their bound is pass A's (the
//       live products), as for K2.
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
// covers its own tiles only, 2.91 GB for half of the VOS rows), then reads
// each query row of it back once:
//   1. affinity_kernel: a tensor-core product (mma.sync, 128 queries x 128
//      keys per block, operands staged by cp.async and split once in shared
//      memory; see the kernel), with the masks computed from coordinates in
//      the epilogue and all-masked fragments not multiplied.
//   2. select_kernel: one block per query row loads the row (T * win^2
//      affinities, 49.6 KB at T = 6, win = 46) into shared memory with one
//      read, bounds the k-th largest element from below by the threads'
//      maxima, compacts the few elements above the bound in key order, and
//      runs the Pallas kernel's fused distinct-value rounds over them (the
//      whole row where the bound leaves too many); the value mix is
//      k-sparse, so instead of a dense weight x value product the block
//      compacts the selected keys in key order and one thread per value
//      channel sums their values.  Rows longer than shared memory holds are
//      swept from the scratch instead.  Both sums run in one fixed order,
//      whatever path a row takes: z over the distinct values in descending
//      order, then the tie term; the value mix over the selected keys in
//      ascending key order.
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
// is bound by its bytes: the scratch read once, the values (12.6 MB) and
// the output (2.1 MB), 0.253 ms at TAP-Vid shapes and 1.634 ms at VOS
// shapes; its rounds and gather are a few hundred operations a row.
// Keeping the affinities on chip is later work.

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

// select_kernel: passes B and C, one block of THREADS threads per query row.
//   load    the row (T * win^2 affinities) is read from the scratch once,
//           16 bytes a thread and step, into shared memory ("resident"); each
//           thread keeps the largest live finite element it loaded.
//   bound   the k-th largest of a warp's 32 thread maxima (a warp bitonic
//           sort) is held by k distinct elements, so it is at most the row's
//           k-th largest; the block takes the largest of its warps' bounds.
//   candidates  the live elements at or above the bound (usually a few
//           dozen) are compacted into a buffer of CAP entries in ascending
//           key order: a count over each thread's contiguous share of the
//           row, a block-wide scan, a write.  Their values are fetched into
//           shared memory (cp.async, over the row) while pass B runs.  Where
//           more than CAP qualify (ties, flat regions, under-full rows), pass
//           B runs over the whole row instead.
//   pass B  the Pallas kernel's fused rounds: one comparison `a < prev` a
//           live element gives both the largest value below the previous
//           round's and the count at or above it (at most k + 1 rounds).
//           Warp 0 alone sweeps the candidates (two warp reductions a round,
//           no barrier); the whole row takes every warp and one
//           shared-memory exchange a round.  The candidates hold every
//           element at or above the threshold, so the values and counts are
//           the row's.  z is summed over the distinct values in descending
//           order, then the tie term.
//   pass C  one thread per value channel sums the selected keys (live, at or
//           above the threshold) in ascending key order through mix<MODE>,
//           from 0: over the candidates' fetched values, the
//           others' weights marked -1; from the whole row, SEG entries at a
//           time compacted in order with their weights and value pixels, the
//           values read from the L2.
// No second read of the scratch.  A row longer than shared memory holds takes
// the same code with the row read from the scratch (the L2) at each sweep
// (RES = false).
namespace {

constexpr int NWARP = THREADS / 32;
constexpr int CAP = 512;              // candidate / selection buffer entries
constexpr int SEG = CAP;              // list entries one selection step takes
constexpr int PER = SEG / THREADS;    // of them a thread's, contiguous
constexpr int GATHER_UNROLL = 8;      // value loads in flight per channel
// dynamic shared memory a select block may take: the card's 232,448 bytes a
// block less room for the static arrays
constexpr int SEL_SMEM_MAX = 232448 - 2048;

__device__ __forceinline__ bool is_live(float a) { return a > NEG * 0.5f; }

// The lanes' values sorted in descending order (bitonic, over the warp).
__device__ __forceinline__ float warp_sort_desc(float x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(FULL, x, stride);
      const bool desc = (lane & size) == 0 || size == 32;
      const bool low = (lane & stride) == 0;
      x = (low == desc) ? fmaxf(x, o) : fminf(x, o);
    }
  }
  return x;
}

// Exclusive prefix sum of x over the block in thread order; `total` gets
// the block's sum.  wsum (NWARP ints) must not be read by another scan
// until a barrier has passed.
__device__ __forceinline__ int block_scan(int x, int* wsum, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int off = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const int s = wsum[w];
    off += w < warp ? s : 0;
    total += s;
  }
  return off + inc - x;
}

// The largest of the lanes' values (not NaN), by one warp reduction of
// their order-preserving integer images.
__device__ __forceinline__ float warp_max(float x) {
  const int i = __float_as_int(x);
  const int m = __reduce_max_sync(FULL, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// 4 bytes from global to shared memory, through the L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Pass B's running statistics over the row's distinct live values, in
// descending order.
struct Rounds {
  float prev, mmax, tv, zab;
  int tc, nab, cum, base;
  bool any;

  __device__ void init() {
    prev = INFINITY;
    mmax = tv = NEG;
    zab = 0.f;
    tc = nab = cum = base = 0;
    any = false;
  }
  // Takes round r's sweep: m, the largest live value below prev (the next
  // distinct value), and c, the count of live elements at or above prev,
  // which completes prev's count (`base`, round 0's count at or above
  // +inf, is left out of the values).  Returns true when the statistics
  // are complete.
  __device__ bool step(int r, float m, int c, int k) {
    if (r == 0) {
      base = c;
    } else {
      const int cnt = c - base - cum;
      if (!any) {
        mmax = prev;
        any = true;
      } else {
        zab += expf(fminf(tv - mmax, 0.f)) * (float)tc;  // previous, above
      }
      tv = prev;
      tc = cnt;
      nab = cum;
      cum += cnt;
      if (cum >= k) return true;
    }
    if (!is_live(m)) return true;  // no live value left: under-full row
    prev = m;
    return false;
  }
};

}  // namespace

// PASSES: 3 runs passes B and C ('abc'); 2 stops after pass B's statistics
// (K5 cut 'ab') and writes [thresh, mmax, z, frac, n_above, cnt_at] into
// channels 0..5 of the query pixel's output row, zeros into the rest (the
// first Cv of the six where Cv < 6), with no selection and no gather.
// Dynamic shared memory: CAP floats and CAP ints, then (RES) the row.
template <int MODE, int PASSES, bool RES>
__global__ void __launch_bounds__(THREADS, 4)
select_kernel(const float* __restrict__ aff, const float* __restrict__ v,
              float* __restrict__ out, const TopkAttnParams p) {
  extern __shared__ __align__(16) float sel_smem[];
  float* const bval = sel_smem;                              // candidates' values,
  int* const bidx = reinterpret_cast<int*>(sel_smem + CAP);  // keys; then weights, pixels
  float* const srow = sel_smem + 2 * CAP;                    // the resident row
  __shared__ float red_m[2][NWARP];
  __shared__ int red_c[2][NWARP];
  __shared__ int wsum[NWARP];
  __shared__ float wmax[NWARP];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntw = p.Wp / p.tile;
  const long long g = blockIdx.x;
  const int tile_id = (int)(g / S), s = (int)(g % S);
  const int r0 = (tile_id / ntw) * p.tile, c0 = (tile_id % ntw) * p.tile;
  const int gi = r0 + s / p.tile, gj = c0 + s % p.tile;  // gi: block row
  if (p.row0 + gi >= p.H || gj >= p.W) return;  // query-grid padding (whole block)

  const int K = p.T * FK;
  const int k = p.topk;
  const float* const grow = aff + (size_t)g * K;

  // ---- load: one read of the row; each thread's largest live finite
  // element (and, for cut 'ab', its largest element) ----
  float tmax = -INFINITY, amax = -INFINITY;
  auto see = [&](float a) {
    if (is_live(a) && a < INFINITY) tmax = fmaxf(tmax, a);
    if (PASSES == 2) amax = fmaxf(amax, a);
  };
  if (K % 4 == 0) {  // rows 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(grow);
    for (int i = tid; i < K / 4; i += THREADS) {
      const float4 x = RES ? __ldcs(src + i) : src[i];
      if (RES) reinterpret_cast<float4*>(srow)[i] = x;
      see(x.x);
      see(x.y);
      see(x.z);
      see(x.w);
    }
  } else {
    for (int i = tid; i < K; i += THREADS) {
      const float a = grow[i];
      if (RES) srow[i] = a;
      see(a);
    }
  }
  const float* const row = RES ? srow : grow;

  // ---- bound: the largest of the warps' k-th largest thread maxima ----
  const float wk = __shfl_sync(FULL, warp_sort_desc(tmax, lane), k - 1);
  if (lane == 0) wmax[warp] = wk;
  __syncthreads();  // the row is resident
  float bound = wmax[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) bound = fmaxf(bound, wmax[w]);

  // ---- candidates, in ascending key order ----
  const int chunk = (K + THREADS - 1) / THREADS;
  const int j0 = min(K, tid * chunk), j1 = min(K, j0 + chunk);
  int mine = 0;
  for (int j = j0; j < j1; ++j) {
    const float a = row[j];
    mine += is_live(a) && a >= bound;
  }
  int n;
  int off = block_scan(mine, wsum, n);
  const bool fits = n <= CAP;
  if (fits) {
    for (int j = j0; j < j1 && mine; ++j) {
      const float a = row[j];
      if (is_live(a) && a >= bound) {
        bval[off] = a;
        bidx[off] = j;
        ++off;
        --mine;
      }
    }
  }
  __syncthreads();
  const float* const list = fits ? bval : row;  // what the rounds sweep
  const int len = fits ? n : K;

  // the value pixel of a live key (live keys lie in the image; global rows)
  auto value_pixel = [&](int key) {
    const int t = key / FK, f = key % FK;
    const int vy = p.row0 + r0 + f / p.win - p.halo;
    const int vx = c0 + f % p.win - p.halo;
    return (t * p.H + vy) * p.W + vx;
  };
  // The candidates' values are fetched into shared memory over the row
  // (the candidates replaced it) while the rounds run; their keys become
  // value pixels in place.
  const bool prefetch = PASSES == 3 && RES && fits && p.Cv <= THREADS && n * p.Cv <= K;
  if (prefetch) {
    for (int e = tid; e < n; e += THREADS) bidx[e] = value_pixel(bidx[e]);
    __syncthreads();
    for (int i = tid; i < n * p.Cv; i += THREADS) {
      const int e = i / p.Cv;
      cp_async4(srow + i, v + (size_t)bidx[e] * p.Cv + (i - e * p.Cv));
    }
    cp_async_commit();
  }

  // ---- pass B: fused rounds over the list, by warp 0 alone on the
  // candidates (no barrier a round) or by the block on the whole row ----
  auto sweep = [&](float prev, int first, int step, float& m, int& c) {
    m = -INFINITY;
    c = 0;
    for (int j = first; j < len; j += step) {
      const float a = list[j];
      if (!is_live(a)) continue;
      if (a < prev) {
        m = fmaxf(m, a);
      } else {
        ++c;
      }
    }
    m = warp_max(m);
    c = __reduce_add_sync(FULL, c);
  };
  __shared__ Rounds shared_rounds;
  Rounds rs;
  rs.init();
  if (fits) {
    if (warp == 0) {
      for (int r = 0;; ++r) {
        float m;
        int c;
        sweep(rs.prev, lane, 32, m, c);
        if (rs.step(r, m, c, k)) break;
      }
      if (lane == 0) shared_rounds = rs;
    }
    __syncthreads();
    rs = shared_rounds;
  } else {
    for (int r = 0;; ++r) {
      float m;
      int c;
      sweep(rs.prev, tid, THREADS, m, c);
      if (lane == 0) {
        red_m[r & 1][warp] = m;
        red_c[r & 1][warp] = c;
      }
      __syncthreads();
      m = red_m[r & 1][0];
      c = red_c[r & 1][0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) {
        m = fmaxf(m, red_m[r & 1][w]);
        c += red_c[r & 1][w];
      }
      if (rs.step(r, m, c, k)) break;
    }
  }
  const bool any = rs.any;
  const float mmax = rs.mmax;
  const float thresh = any ? rs.tv : NEG;
  const float cnt_at = any ? (float)rs.tc : 0.f;
  const float frac =
      fminf(fmaxf((float)k - (float)rs.nab, 0.f), cnt_at) / fmaxf(cnt_at, 1.f);
  float z = rs.zab;
  if (any) z += frac * cnt_at * expf(fminf(thresh - mmax, 0.f));
  z = fmaxf(z, 1e-30f);
  float* const op = out + ((size_t)gi * p.W + gj) * p.Cv;

  if constexpr (PASSES == 2) {
    // Pass B's max is the row's largest element, live or not (round 0 of
    // the Pallas rounds); a row with no live key takes the loaded maxima.
    float rmax = mmax;
    if (!any) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
      if (lane == 0) wmax[warp] = amax;
      __syncthreads();
      rmax = wmax[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) rmax = fmaxf(rmax, wmax[w]);
    }
    const float stats[6] = {thresh, rmax, z, frac, (float)rs.nab, cnt_at};
    for (int ch = tid; ch < p.Cv; ch += THREADS) op[ch] = ch < 6 ? stats[ch] : 0.f;
    return;
  }

  // ---- pass C: the value mix over the selected keys (k-sparse), in
  // ascending key order, in the mode's arithmetic: w is computed in f32 and
  // rounded per mode with v ----
  auto weight = [&](float a) {
    return expf(fminf(a - mmax, 0.f)) * (a > thresh ? 1.f : frac);
  };
  if (prefetch) {
    // each candidate's weight, -1 where it is not selected (all are live);
    // then one thread per channel sums the selected ones in key order
    for (int e = tid; e < n; e += THREADS) {
      const float a = bval[e];
      bval[e] = any && a >= thresh ? weight(a) : -1.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tid < p.Cv) {
      float acc = 0.f;
      for (int e = 0; e < n; ++e) {
        const float w = bval[e];
        if (w >= 0.f) acc = mix<MODE>(w, srow[e * p.Cv + tid], acc);
      }
      op[tid] = acc / z;
    }
    return;
  }
  // The selected keys of list entries [e0, e0 + SEG), compacted in order
  // into bval (weights) and bidx (value pixels); returns their number.
  auto select_keys = [&](int e0) {
    float w[PER];
    int px[PER];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = e0 + PER * tid + u;
      const float a = e < len ? list[e] : NEG;
      const int key = fits ? (e < len ? bidx[e] : 0) : e;
      px[u] = -1;
      if (is_live(a) && a >= thresh) {
        w[u] = weight(a);
        px[u] = value_pixel(key);
        ++cnt;
      }
    }
    int nsel;
    int at = block_scan(cnt, wsum, nsel);  // every list read is done
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (px[u] >= 0) {
        bval[at] = w[u];
        bidx[at] = px[u];
        ++at;
      }
    }
    __syncthreads();
    return nsel;
  };
  // channel ch of the nsel compacted keys added to acc, in order
  auto gather = [&](int nsel, int ch, float acc) {
    for (int e = 0; e < nsel; e += GATHER_UNROLL) {
      float vv[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u)
        vv[u] = e + u < nsel ? __ldg(v + (size_t)bidx[e + u] * p.Cv + ch) : 0.f;
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u)
        if (e + u < nsel) acc = mix<MODE>(bval[e + u], vv[u], acc);
    }
    return acc;
  };
  // candidates: one segment, selected once (in place) for every channel
  const int nfit = any && fits ? select_keys(0) : 0;
  for (int cb = 0; cb < p.Cv; cb += THREADS) {
    const int ch = cb + tid;
    float acc = 0.f;
    if (fits) {
      if (ch < p.Cv) acc = gather(nfit, ch, acc);
    } else {
      for (int e0 = 0; any && e0 < len; e0 += SEG) {
        const int nsel = select_keys(e0);
        if (ch < p.Cv) acc = gather(nsel, ch, acc);
        __syncthreads();
      }
    }
    if (ch < p.Cv) op[ch] = acc / z;
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

// Lets `kernel` take `bytes` of dynamic shared memory, with the SM's
// carveout given to shared memory.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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
    // one block per query row; the row resident in shared memory where it fits
    const unsigned nq = (unsigned)(ntiles * S);
    const int K = p.T * FK;
    const int res_smem = 4 * (2 * CAP + (K + 3) / 4 * 4);
    if (res_smem <= SEL_SMEM_MAX) {
      err = set_smem(select_kernel<MODE, PASSES, true>, res_smem);
      if (err != cudaSuccess) return (int)err;
      select_kernel<MODE, PASSES, true><<<nq, THREADS, res_smem, stream>>>(scratch, v, out, p);
    } else {
      select_kernel<MODE, PASSES, false><<<nq, THREADS, 4 * 2 * CAP, stream>>>(scratch, v, out,
                                                                              p);
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
