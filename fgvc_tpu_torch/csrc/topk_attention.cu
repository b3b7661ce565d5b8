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
//   'float32'   (fgvc_topk_attention_f32) f32 query, bank and values, f32
//               products: the Pallas Precision.HIGHEST matmuls.
//   'high'      (fgvc_topk_attention_high) f32 operands, each split as
//               x = hi + lo with hi = bf16(x), lo = bf16(x - hi), both rounded
//               to nearest even; q.k = sum hi.hi + hi.lo + lo.hi (no lo.lo),
//               and the value mix sum w_hi.v_hi + w_hi.v_lo + w_lo.v_hi: the
//               Pallas manual bf16x3 (_make_kernel :114-121, :192-199,
//               :366-391).  Three products per channel instead of one.
//   'bfloat16'  (fgvc_topk_attention_bf16) the query and the bank are bf16
//               (normalised in f32, then rounded by the wrapper); q.k sums
//               bf16 x bf16 products in f32, and the value mix sums bf16(w) x
//               bf16(v) in f32, with w computed in f32 and the values handed
//               over in f32 and rounded here (:201-214, :353-365, :611-614).
// A product of two bf16 values is exact in f32, so in 'high' and 'bfloat16'
// only the order of the f32 sums can differ from another implementation;
// this kernel sums each (query, key) pair's products channel by channel from
// 0 (hi.hi, hi.lo, lo.hi within a channel), which the plain PyTorch version
// of those modes repeats, so the two give the same affinities bit for bit:
// the same top-k members near a tie, and in 'bfloat16' the same bf16
// rounding of each weight w (one f32 ulp could flip it). Masks, the top-k
// statistics and the tie split are the same in every mode.
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
//   1. affinity_kernel: a tiled f32 SIMT matrix product (64 queries x 64 keys
//      per block, 4 x 4 outputs per thread, channels staged through shared
//      memory in chunks of 16), with the masks computed from coordinates in
//      the epilogue.  Every (query, key) dot product is summed in the same
//      order wherever it is computed, so a key frame that sits in two slots
//      gives bit-identical affinities: exact ties, as on the TPU.
//   2. select_kernel: each lane keeps the exact top distinct values of its
//      strided share of the row with their counts (enough entries to reach k
//      elements); the warp merges the 32 lists by distinct-value rounds,
//      which gives the same statistics as the Pallas kernel's pass B.  The
//      value mix is k-sparse, so instead of a dense weight x value product
//      the warp rescans its row for the keys at or above the threshold and
//      gathers their value vectors, one channel per lane.
//
// What bounds it on an H100: the affinity product.  At the TAP-Vid shapes
// (128 x 128 queries, T = 6, radius 15, circle, C = 256) the live
// (in-window, in-image, valid-slot) pairs need 31.69 GFLOP per call; the
// dense halo windows computed here are 106.5 GFLOP, against 67 TFLOP/s of
// fp32 outside the tensor cores.  The scratch round trip moves 2.5 GB
// (written once, read twice).  At the DAVIS VOS shapes (240 x 440 queries,
// square) the live pairs need 296 GFLOP and the dense windows 699 GFLOP.
// Tensor cores (3xTF32), skipping the dead window corners and keeping the
// affinities on chip are later work.
//
// K3's bounds: 'bfloat16' is the same live work at 989 TFLOP/s of bf16 tensor
// cores with the query and the bank at 2 bytes an element (0.032 ms at the
// TAP-Vid shapes, 0.300 ms at the VOS shapes); 'high' is three times the
// products at that rate (0.096 and 0.899 ms).  This first K3 runs its
// products as SIMT FMAs on bf16-rounded operands, so it is bound by the same
// f32 SIMT rate as 'float32': 'high' does three times the affinity work of
// 'float32', 'bfloat16' the same work from half the bytes.  mma.sync or wgmma
// with bf16 operands is later work; it must keep one summation order per
// (query, key) pair for the tie case.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FGVC_MAX_T 16

namespace {

constexpr float NEG = -1e30f;
constexpr int BM = 64;   // queries per affinity block
constexpr int BN = 64;   // keys per affinity block
constexpr int BK = 16;   // channels per shared-memory stage
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

// four consecutive channels of an operand row as f32 (zeros where !ok)
__device__ __forceinline__ float4 load4(const float* row, int c, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(row + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row + c);
  const float2 a = __bfloat1622float2(p[0]);
  const float2 b = __bfloat1622float2(p[1]);
  return make_float4(a.x, a.y, b.x, b.y);
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

template <int MODE>
__global__ void __launch_bounds__(THREADS)
affinity_kernel(const typename Operand<MODE>::T* __restrict__ q,
                const typename Operand<MODE>::T* __restrict__ bank,
                float* __restrict__ aff, const TopkAttnParams p) {
  using T = typename Operand<MODE>::T;
  constexpr bool HIGH = MODE == MODE_HIGH;
  // As/Bs hold the operands ('high': their bf16 hi halves), Al/Bl the lo
  // halves of 'high' (one unused row otherwise)
  constexpr int LO = HIGH ? BK : 1;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ __align__(16) float Al[LO][BM + 4];
  __shared__ __align__(16) float Bl[LO][BN + 4];

  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntw = p.Wp / p.tile;
  const int t = blockIdx.z % p.T;
  const int tile_id = blockIdx.z / p.T;
  const int r0 = (tile_id / ntw) * p.tile;
  const int c0 = (tile_id % ntw) * p.tile;
  const int s0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key group of this thread's 4 x 4 outputs
  const int ty = tid / 16;  // query group

  // each thread stages one float4 of one query row and one key row per chunk
  const int lrow = tid / 4;
  const int lc = (tid % 4) * 4;
  const int s_ld = s0 + lrow;
  const int f_ld = f0 + lrow;
  const bool s_ok = s_ld < S;
  const bool f_ok = f_ld < FK;
  const T* qrow = q;
  if (s_ok) {  // the query row is local to the block
    const int qi = s_ld / p.tile, qj = s_ld % p.tile;
    qrow = q + ((size_t)(r0 + qi) * p.Wp + (c0 + qj)) * p.C;
  }
  const T* krow = bank;
  if (f_ok) {  // the bank row is global
    const int wi = f_ld / p.win, wj = f_ld % p.win;
    const int krow_g = p.row0 + r0 + wi;
    krow = bank + (((size_t)p.frame_idx[t] * p.rows_total + krow_g) * p.cols_total +
                   (c0 + wj)) *
                      p.C;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Each output sums its channels in order 0 .. C-1 (per channel: hi.hi,
  // hi.lo, lo.hi in 'high'), whichever block computes it.
  for (int k0 = 0; k0 < p.C; k0 += BK) {
    const float4 a4 = load4(qrow, k0 + lc, s_ok);
    const float4 b4 = load4(krow, k0 + lc, f_ok);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (HIGH) {
        const float ah = bf16_round(a[c]), bh = bf16_round(b[c]);
        As[lc + c][lrow] = ah;
        Bs[lc + c][lrow] = bh;
        Al[(lc + c) % LO][lrow] = bf16_round(a[c] - ah);
        Bl[(lc + c) % LO][lrow] = bf16_round(b[c] - bh);
      } else {
        As[lc + c][lrow] = a[c];
        Bs[lc + c][lrow] = b[c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
      if (HIGH) {
        const float4 alv = *reinterpret_cast<const float4*>(&Al[kk % LO][ty * 4]);
        const float4 blv = *reinterpret_cast<const float4*>(&Bl[kk % LO][tx * 4]);
        const float al[4] = {alv.x, alv.y, alv.z, alv.w};
        const float bl[4] = {blv.x, blv.y, blv.z, blv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
            acc[i][j] = fmaf(ar[i], bl[j], acc[i][j]);
            acc[i][j] = fmaf(al[i], br[j], acc[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const size_t row_len = (size_t)p.T * FK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= S) continue;
    const int qi = s / p.tile, qj = s % p.tile;
    float* out_row = aff + ((size_t)tile_id * S + s) * row_len + (size_t)t * FK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= FK) continue;
      const int wi = f / p.win, wj = f % p.win;
      // the Pallas kernel's masks, in the same float arithmetic: strict
      // circle or inclusive square, image-border strip, per-slot validity
      const float dy = (float)(wi - p.halo - qi);
      const float dx = (float)(wj - p.halo - qj);
      const bool in_range =
          p.square ? (fabsf(dy) <= p.radius && fabsf(dx) <= p.radius)
                   : __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) < p.rr;
      const int kgi = p.row0 + r0 + wi - p.halo, kgj = c0 + wj - p.halo;
      const bool in_img = kgi >= 0 && kgi < p.H && kgj >= 0 && kgj < p.W;
      const float bias = __fadd_rn(in_range ? 0.f : NEG, in_img ? 0.f : NEG);
      out_row[f] = __fadd_rn(__fadd_rn(__fmul_rn(acc[i][j], p.inv_temp), bias),
                             p.frame_bias[t]);
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
  const dim3 grid_a((FK + BN - 1) / BN, (S + BM - 1) / BM, ntiles * p.T);
  affinity_kernel<MODE><<<grid_a, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(bank), scratch, p);
  cudaError_t err = cudaGetLastError();
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
