// Tensor-core / SIMT issue-overlap microbenchmark (K6), for sm_90a.
//
// Replaces the Pallas TPU kernel of tools/bench/mxu_vpu_overlap.py (`make`
// :31, `pallas_call` :92), which asked whether the TPU's matrix unit and its
// vector unit overlap data-independent work inside one kernel.  This file
// asks the same of an H100: do tensor-core products and SIMT count/max
// rounds, issued by independent warps of one block, overlap on one SM?
//
// Shapes (those of the original): q (S, C) = (256, 256) f32, k (T, FK, C) =
// (6, 2304, 256) f32, out (S, 128) f32, and a (S, T * FK) f32 scratch of 14.2
// MB.  The three kinds compute what the Pallas kinds compute:
//   mxu    out = sum_t (q . k_t^T)[:, :128], frames in order; each (S, FK)
//          product is also stored into the scratch at columns t * FK.
//   vpu    scratch[:, :FK] = q[:, 0]; then R = 11 rounds of
//          cge = count(a >= prev), m = max(a < prev ? a : NEG), prev = m,
//          tot += cge over the whole (S, T * FK) scratch row; out = tot.
//          Columns FK.. are never written: the wrapper allocates the scratch
//          filled with NaN (what Pallas interpret mode gives there), so every
//          row is 10 * FK.
//   mixed  per frame the product (stored, and its first 128 columns summed)
//          and 2 rounds over frame 0's block (2T = 12 in all); out = acc +
//          tot.  After frame 0 the two streams share no data.
//
// Design.  One block per BM = 16 rows (one m16 tile; 16 blocks in all: the
// TPU version measured one core, this measures one SM at a time), 8 warps:
//   * 4 tensor-core warps: mma.sync m16n8k8 TF32 with the 3xTF32 split
//     (x = big + small, big = tf32(x), small = tf32(x - big); q.k = small.big
//     + big.small + big.big, f32 accumulation), which stands in for the
//     TPU's HIGHEST f32 matrix unit (a product of f32 operands to about
//     2^-21 relative).  The block's 16 query rows sit in shared memory,
//     split once, in fragment order.  The key rows stream from device memory
//     (the L2 holds all 14.2 MB of k) by cp.async into a ring of four
//     shared-memory stages of 32 key rows x 32 channels per warp, three
//     stages in flight, read into fragments (two float4s a lane and stage)
//     from rows padded to 48 words (no bank conflicts).  Each key element feeds one warp's products once
//     (the block has one m16 tile of queries), so it is split once, into big
//     and small, as its fragment is read: a split buffer in shared memory
//     would only add traffic.  Each block reads k once.  Warp w owns column
//     groups w, w + 4, ... of 32 columns (4 n-tiles); group w < 4 covers the
//     first 128 columns, so warp w keeps those columns' sum in registers.
//     A warp synchronises with __syncwarp only.
//   * 4 SIMT warps: the count/max rounds, 4 rows per warp interleaved,
//     float4 loads, warp-shuffle reductions.  The scratch lives in device
//     memory (L2).
// mxu runs only the tensor-core warps, vpu only the SIMT warps (the
// tensor-core warps idle), mixed both: after frame 0 (and a block barrier
// that makes its block visible) the tensor-core warps run frames 1..5 while
// the SIMT warps run all 12 rounds.  So the times of the three kinds read
// as the Pallas ones do: overlap quality (mxu + vpu * 12/66 - mixed) /
// (vpu * 12/66), 1.0 when the rounds hide fully behind the products.
//
// What a row-block CTA measures: 16 blocks fill 16 of 132 SMs, one block
// per SM, so the times are those of one SM's tensor cores, SIMT pipes and
// L2 port, not of the card.  The bound below is the card's.
//
// Bound on an H100 (the card's published peaks, 700 W):
//   mxu    2 * S * C * T * FK = 1.812 GFLOP; three TF32 products each at 495
//          TFLOP/s is 11.0 us, against 28.7 MB of q, k, out and scratch
//          writes at 3.35 TB/s (8.6 us): bound by operations, 11.0 us.
//   vpu    R * S * T * FK = 38.9 M element-rounds at 4 SIMT operations
//          (compare, select, max, count) at 33.5 T operations/s: 4.6 us.
//   mixed  the mxu bound: the 2T rounds over frame 0's block (28.3 M
//          operations, 0.85 us) fit under the products when they overlap.
// These kernels run for tens to hundreds of microseconds; the timing
// launches them back to back on one stream, so the host's launch cost
// (a few microseconds a call) hides behind the previous launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S = 256, FK = 2304, C = 256, T = 6, R = 11, OUTW = 128;
constexpr int LDS = T * FK;          // scratch row length
constexpr float NEG = -1e30f;
constexpr int BM = 16;               // rows per block
constexpr int MMA_WARPS = 4, SIMT_WARPS = 4;
constexpr int THREADS = 32 * (MMA_WARPS + SIMT_WARPS);
constexpr int NT = 4;                // n-tiles of 8 columns per warp and stage
constexpr int ROWS = BM / SIMT_WARPS;
constexpr unsigned FULL = 0xffffffffu;

constexpr int KIND_MXU = 0, KIND_VPU = 1, KIND_MIXED = 2;

static_assert(MMA_WARPS * NT * 8 == OUTW, "warp w < 4 owns output columns");
static_assert(FK % 128 == 0, "float4 rounds cover whole rows");
static_assert(C % 32 == 0, "products take the channels 32 at a time");

// The key stream of a tensor-core warp: stages of KT key rows (its 32-column
// group) x KB channels, a ring of KSTAGES per warp filled by cp.async.  Each
// key element feeds one warp's products once, so it is split once, as its
// fragment is read.
constexpr int KT = NT * 8;              // key rows (output columns) of a stage
constexpr int KB = 32;                  // channels of a stage
constexpr int LDK = KB + 16;            // row stride in words: a quarter warp's
                                        // float4 reads (2 rows) hit 32 banks
constexpr int KSTAGES = 4;
constexpr int KSTAGE_WORDS = KT * LDK;
constexpr int GROUPS = FK / KT, NCB = C / KB;
constexpr int PRODUCT_SMEM = 4 * MMA_WARPS * KSTAGES * KSTAGE_WORDS;
static_assert(FK % KT == 0 && C % KB == 0 && GROUPS % MMA_WARPS == 0, "stages cover the keys");
static_assert(MMA_WARPS * KT == OUTW, "group w < 4 owns output columns 32 w ..");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32 (rounded to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Frame t's product for the block's rows: this warp's column groups of
// q . k_t^T in 3xTF32, stored into the scratch (srows: the block's first
// row); the first group (columns 32 * warp ..) is added to acc.
//
// Warp w owns column groups w, w + 4, ... of KT = 32 columns; it streams
// their key rows in stages of KB = 32 channels (stage st: group w + 4 (st /
// NCB), channel block st % NCB) through its own ring in shared memory
// (wring), KSTAGES - 1 stages in flight while one is multiplied, and
// synchronises with __syncwarp only.  A key element is read into a fragment
// once and split there.  The block's 16 query rows come split, per m16n8k8
// step and lane.  Within a stage of 32 channels the k8 step s (0..3) pairs
// its k index tig with channel 4 tig + s and tig + 4 with 16 + 4 tig + s
// (tig = lane % 4), for the query fragment and the key fragment alike: a dot
// product over the same channels in another order.  So a lane reads its key
// row's channels 4 tig .. + 3 and 16 + 4 tig .. + 3 of a stage as two
// float4s, its fragments of all four steps.
__device__ __forceinline__ void product_frame(const uint4* Abig, const uint4* Asmall,
                                              uint32_t* wring, const float* kt, float* srows,
                                              int t, float (&acc)[NT][4], int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int NST = GROUPS / MMA_WARPS * NCB;
  constexpr int PARTS = KB / 4;  // 16-byte pieces of a staged row
  auto load = [&](int st) {
    uint32_t* dst = wring + (st % KSTAGES) * KSTAGE_WORDS;
    const int g = warp + MMA_WARPS * (st / NCB);
    const float* src = kt + (size_t)g * KT * C + (st % NCB) * KB + (lane % PARTS) * 4;
#pragma unroll
    for (int j = 0; j < KT * PARTS / 32; ++j) {
      const int row = lane / PARTS + (32 / PARTS) * j;
      cp_async16(dst + row * LDK + (lane % PARTS) * 4, src + (size_t)row * C);
    }
  };
  __syncwarp();  // the previous frame's reads of the ring are done
#pragma unroll
  for (int st = 0; st < KSTAGES - 1; ++st) {
    load(st);
    cp_async_commit();
  }
  float d[NT][4];
#pragma unroll 1
  for (int st = 0; st < NST; ++st) {
    cp_async_wait<KSTAGES - 2>();
    __syncwarp();  // stage st landed; the slot of stage st - 1 is free
    if (st + KSTAGES - 1 < NST) load(st + KSTAGES - 1);
    cp_async_commit();
    const float* X = reinterpret_cast<const float*>(wring + (st % KSTAGES) * KSTAGE_WORDS);
    const int cb = st % NCB, g = warp + MMA_WARPS * (st / NCB);
    if (cb == 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
    }
    float4 x4[NT], y4[NT];  // this lane's key fragments of the stage
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float* r = X + (i * 8 + gid) * LDK + 4 * tig;
      x4[i] = *reinterpret_cast<const float4*>(r);
      y4[i] = *reinterpret_cast<const float4*>(r + 16);
    }
#pragma unroll
    for (int s4 = 0; s4 < KB / 8; ++s4) {
      const uint4 ab4 = Abig[(cb * (KB / 8) + s4) * 32 + lane];
      const uint4 as4 = Asmall[(cb * (KB / 8) + s4) * 32 + lane];
      const uint32_t ab[4] = {ab4.x, ab4.y, ab4.z, ab4.w};
      const uint32_t as[4] = {as4.x, as4.y, as4.z, as4.w};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float x[4] = {x4[i].x, x4[i].y, x4[i].z, x4[i].w};
        const float y[4] = {y4[i].x, y4[i].y, y4[i].z, y4[i].w};
        uint32_t bb[2], bs[2];
        split(x[s4], bb[0], bs[0]);
        split(y[s4], bb[1], bs[1]);
        mma(d[i], as, bb);
        mma(d[i], ab, bs);
        mma(d[i], ab, bb);
      }
    }
    if (cb == NCB - 1) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int col = t * FK + g * KT + i * 8 + tig * 2;
        *reinterpret_cast<float2*>(srows + (size_t)gid * LDS + col) = make_float2(d[i][0], d[i][1]);
        *reinterpret_cast<float2*>(srows + (size_t)(gid + 8) * LDS + col) =
            make_float2(d[i][2], d[i][3]);
        if (g == warp) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += d[i][j];
        }
      }
    }
  }
}

// `nrounds` rounds over columns [0, ncols) of this warp's ROWS rows.
__device__ __forceinline__ void rounds(const float* srows, int ncols, int nrounds,
                                       float (&prev)[ROWS], float (&tot)[ROWS], int lane) {
  for (int r = 0; r < nrounds; ++r) {
    int cnt[ROWS];
    float m[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      cnt[j] = 0;
      m[j] = NEG;
    }
#pragma unroll 2
    for (int c = lane * 4; c < ncols; c += 128) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float4 x4 = *reinterpret_cast<const float4*>(srows + (size_t)j * LDS + c);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cnt[j] += x[e] >= prev[j];
          m[j] = fmaxf(m[j], x[e] < prev[j] ? x[e] : NEG);  // NaN: neither
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        cnt[j] += __shfl_xor_sync(FULL, cnt[j], o);
        m[j] = fmaxf(m[j], __shfl_xor_sync(FULL, m[j], o));
      }
      prev[j] = m[j];
      tot[j] += (float)cnt[j];
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
overlap_kernel(const float* __restrict__ q, const float* __restrict__ k,
               float* __restrict__ out, float* scratch) {
  extern __shared__ __align__(16) uint32_t ring[];  // the warps' key rings (mxu, mixed)
  // the block's query rows split into tf32 halves, in fragment order: per
  // m16n8k8 step (C / 8 of them) and lane, the 4 words a0..a3
  __shared__ uint4 Abig[C / 8 * 32];
  __shared__ uint4 Asmall[C / 8 * 32];
  __shared__ float tot_s[BM];
  const int r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the block's rows of the scratch; read and written by this block only,
  // through the coherent path (no __restrict__ const: the SIMT warps read
  // what the tensor-core warps wrote)
  float* srows = scratch + (size_t)r0 * LDS;

  if (KIND == KIND_VPU) {
    for (int i = threadIdx.x; i < BM * FK; i += THREADS)
      srows[(size_t)(i / FK) * LDS + i % FK] = q[(size_t)(r0 + i / FK) * C];
  } else {
    for (int i = threadIdx.x; i < C / 8 * 32; i += THREADS) {
      const int ks = i / 32, l = i % 32, gid = l >> 2, tig = l & 3;
      const int c = (ks / 4) * 32 + 4 * tig + ks % 4;  // channel of k index tig
      const float* q0 = q + (size_t)(r0 + gid) * C;
      const float* q8 = q + (size_t)(r0 + gid + 8) * C;
      uint32_t b[4], sm[4];
      split(q0[c], b[0], sm[0]);
      split(q8[c], b[1], sm[1]);
      split(q0[c + 16], b[2], sm[2]);
      split(q8[c + 16], b[3], sm[3]);
      Abig[i] = make_uint4(b[0], b[1], b[2], b[3]);
      Asmall[i] = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  }
  if (threadIdx.x < BM) tot_s[threadIdx.x] = 0.f;
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool tc = warp < MMA_WARPS;
  const int sw = warp - MMA_WARPS;  // SIMT warp index

  if (KIND != KIND_VPU && tc) product_frame(Abig, Asmall, ring + warp * KSTAGES * KSTAGE_WORDS, k, srows, 0, acc, warp, lane);
  if (KIND == KIND_MIXED) __syncthreads();  // frame 0's block is in the scratch
  if (tc) {
    if (KIND != KIND_VPU)
      for (int t = 1; t < T; ++t)
        product_frame(Abig, Asmall, ring + warp * KSTAGES * KSTAGE_WORDS, k + (size_t)t * FK * C, srows, t,
                        acc, warp, lane);
  } else if (KIND != KIND_MXU) {
    float prev[ROWS], tot[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      prev[j] = 1e30f;
      tot[j] = 0.f;
    }
    const float* rows0 = srows + (size_t)sw * ROWS * LDS;
    if (KIND == KIND_VPU) rounds(rows0, LDS, R, prev, tot, lane);
    else rounds(rows0, FK, 2 * T, prev, tot, lane);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) tot_s[sw * ROWS + j] = tot[j];
    }
  }
  __syncthreads();

  if (tc) {  // warp w writes output columns 32 w .. 32 w + 31
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = (warp * NT + i) * 8 + tig * 2;
      float* o0 = out + (size_t)(r0 + gid) * OUTW + col;
      float* o8 = out + (size_t)(r0 + gid + 8) * OUTW + col;
      *reinterpret_cast<float2*>(o0) = make_float2(acc[i][0] + tot_s[gid], acc[i][1] + tot_s[gid]);
      *reinterpret_cast<float2*>(o8) =
          make_float2(acc[i][2] + tot_s[gid + 8], acc[i][3] + tot_s[gid + 8]);
    }
  }
}

}  // namespace

// kind 0 mxu, 1 vpu, 2 mixed.  q (S, C), k (T, FK, C), out (S, 128) and
// scratch (S, T * FK), all f32, contiguous, on the current device.
// Returns the CUDA error of the launch (0 on success).
extern "C" int fgvc_mxu_vpu_overlap(int kind, const float* q, const float* k, float* out,
                                    float* scratch, cudaStream_t stream) {
  const dim3 grid(S / BM);
  cudaError_t err = cudaSuccess;
  if (kind == KIND_MXU) {
    err = cudaFuncSetAttribute(overlap_kernel<KIND_MXU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PRODUCT_SMEM);
    if (err == cudaSuccess)
      overlap_kernel<KIND_MXU><<<grid, THREADS, PRODUCT_SMEM, stream>>>(q, k, out, scratch);
  } else if (kind == KIND_VPU) {
    overlap_kernel<KIND_VPU><<<grid, THREADS, 0, stream>>>(q, k, out, scratch);
  } else if (kind == KIND_MIXED) {
    err = cudaFuncSetAttribute(overlap_kernel<KIND_MIXED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PRODUCT_SMEM);
    if (err == cudaSuccess)
      overlap_kernel<KIND_MIXED><<<grid, THREADS, PRODUCT_SMEM, stream>>>(q, k, out, scratch);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
