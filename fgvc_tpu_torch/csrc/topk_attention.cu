// Windowed top-k attention for label propagation (K1 and K2), float32, for
// sm_90a.
//
// Replaces the Pallas TPU kernel fgvc_tpu/ops/pallas/topk_attention.py
// (_make_kernel, launched by _call_fused_kernel) in 'float32' mode without a
// row block, behind both of its entries, as there: one kernel, two entries.
//   K1  fused_topk_attention_banked: keys come from a bank normalised and
//       halo-padded once per video (TAP-Vid points: circle mask; DAVIS VOS
//       masks: square mask).
//   K2  fused_topk_attention: the caller hands raw (T, H, W, C) keys that
//       the wrapper normalises and halo-pads into the same bank geometry on
//       every call (the save_mem streaming scan of DAVIS VOS, square mask).
// The wrappers (fgvc_tpu_torch/ops/cuda/topk_attention.py) do the padding;
// this file sees a padded bank either way.
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
// features, 5.46 GB for 240 x 440 DAVIS VOS features), then runs one warp per
// query row over it:
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

}  // namespace

// Passed by value from the host (ctypes mirrors this layout field by field).
struct TopkAttnParams {
  int H, W;                // query / value image size
  int Hp, Wp;              // query grid padded to a multiple of tile
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

__global__ void __launch_bounds__(THREADS)
affinity_kernel(const float* __restrict__ q, const float* __restrict__ bank,
                float* __restrict__ aff, const TopkAttnParams p) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

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
  const float* qrow = q;
  if (s_ok) {
    const int qi = s_ld / p.tile, qj = s_ld % p.tile;
    qrow = q + ((size_t)(r0 + qi) * p.Wp + (c0 + qj)) * p.C;
  }
  const float* krow = bank;
  if (f_ok) {
    const int wi = f_ld / p.win, wj = f_ld % p.win;
    krow = bank + (((size_t)p.frame_idx[t] * p.rows_total + (r0 + wi)) *
                       p.cols_total +
                   (c0 + wj)) *
                      p.C;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.C; k0 += BK) {
    const float4 a = s_ok ? *reinterpret_cast<const float4*>(qrow + k0 + lc)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = f_ok ? *reinterpret_cast<const float4*>(krow + k0 + lc)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    As[lc + 0][lrow] = a.x;
    As[lc + 1][lrow] = a.y;
    As[lc + 2][lrow] = a.z;
    As[lc + 3][lrow] = a.w;
    Bs[lc + 0][lrow] = b.x;
    Bs[lc + 1][lrow] = b.y;
    Bs[lc + 2][lrow] = b.z;
    Bs[lc + 3][lrow] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
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
      const int kgi = r0 + wi - p.halo, kgj = c0 + wj - p.halo;
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

template <int KMAX>
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
  const int gi = r0 + s / p.tile, gj = c0 + s % p.tile;
  if (gi >= p.H || gj >= p.W) return;  // query-grid padding

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

  // ---- value mix over the selected keys (k-sparse) ----
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
          const int vy = r0 + f / p.win - p.halo;  // live keys lie in the image
          const int vx = c0 + f % p.win - p.halo;
          const float* vp = v + (((size_t)t * p.H + vy) * p.W + vx) * p.Cv;
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            const int ch = cb + n * 32 + lane;
            if (ch < p.Cv) acc[n] = fmaf(w, vp[ch], acc[n]);
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

// Launches both kernels on `stream`; returns the CUDA error of the launches
// (0 on success).  q: (Hp, Wp, C); bank: (Tb, rows_total, cols_total, C);
// v: (T, H, W, Cv); out: (H, W, Cv); scratch: ntiles * tile^2 * T * win^2.
extern "C" int fgvc_topk_attention_f32(const float* q, const float* bank,
                                       const float* v, float* out,
                                       float* scratch, TopkAttnParams p,
                                       cudaStream_t stream) {
  const int S = p.tile * p.tile;
  const int FK = p.win * p.win;
  const int ntiles = (p.Hp / p.tile) * (p.Wp / p.tile);
  const dim3 grid_a((FK + BN - 1) / BN, (S + BM - 1) / BM, ntiles * p.T);
  affinity_kernel<<<grid_a, THREADS, 0, stream>>>(q, bank, scratch, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)ntiles * S;
  const int grid_b = (int)((nq + THREADS / 32 - 1) / (THREADS / 32));
  if (p.topk < 16) {
    select_kernel<16><<<grid_b, THREADS, 0, stream>>>(scratch, v, out, p);
  } else {
    select_kernel<32><<<grid_b, THREADS, 0, stream>>>(scratch, v, out, p);
  }
  return (int)cudaGetLastError();
}
