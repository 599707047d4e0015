// Flash attention forward (GQA, causal, sliding window), fp32 in and out, on
// Hopper's tensor cores with a 3xTF32 split.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas body _attn_kernel).  Same function: q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D),
// kv head = q head / (Hq/Hkv) for any group size (7 on qwen2-7b), causal and
// sliding-window masks offset by q_offset, online softmax in fp32, ragged kv
// rows loaded as zeros, fully masked kv tiles skipped with the TPU kernel's
// predicate, output (B,Tq,Hq,D); any D up to 128.
//
// Precision.  The inputs are fp32 and the output must match fp32
// attention; one TF32 rounding of q, k, p or v (10 mantissa bits) costs up
// to ~5e-4 of a value, above the 1e-4 tolerance.  So both products,
// S = (scale q) k^T and O = P V, take each operand element x as
// big = tf32(x) and small = tf32(x - big), both rounded to nearest, and sum
// small*big + big*small + big*big on the tensor cores into fp32 (as the
// chunked-CE kernel does).  The tensor cores truncate as they accumulate, so
// every 32-deep slice (4 mma k-steps of D for S, one 32-row kv tile for O)
// is summed into a fresh register tile and added to the running sum with
// one rounded fp32 add.
//
// What bounds it on the H100: the three TF32 products.  At the slice's shape
// (B 4, T 256, Hq 28, Hkv 4, D 128, causal) the live (q, k) pairs need
// 4*D flops each, 1.89 GFLOP, so the split's three products are 5.66 GFLOP,
// 0.0114 ms at the 495 TFLOP/s dense TF32 peak; its bytes (q, k, v, o) are
// ~34 MB, 0.010 ms at 3.35 TB/s.  The same products in fp32 outside the
// tensor cores would take 0.0282 ms at 67 TFLOP/s.  On an H100 it runs at
// ~9x that TF32 bound: each warp's step is a dependent chain (16 k-steps
// of S, the row max and sum over 4 lanes, exp, then P V) with 4 independent
// mma chains at a time, and 2 blocks of 4 warps an SM (242 registers a
// thread, 99 KB of shared memory a block) leave 2 warps per scheduler to
// hide it; the split's integer and float work (4 operations per operand
// element, each warp splitting every k and v fragment it reads) is the
// other large part.
//
// Design (FlashAttention-2).  The TPU grid walks kv tiles in order and
// carries m/l/acc in VMEM scratch; Hopper blocks run in no order, so the kv
// walk is a loop inside one block.  One block per (64-row q tile, q head,
// batch), the heaviest causal q tiles first; 4 warps, each owning 16 q rows
// as one m16 tile of mma.sync.m16n8k8 tf32.  Each 32-row kv tile gives a
// warp a 16 x 32 S tile in registers (QK^T over D: the q fragments come from
// the block's scaled q tile in shared memory, k by ldmatrix), masked, then
// the online softmax on it in registers: the row max and sum over the 4
// lanes that share a row (two shuffles), the sum kept per lane until the
// end.  P goes from the accumulator layout to the A operand of P V without
// moving: the k index of that product is permuted within each 8-row step
// (A's columns t and t+4 are kv rows 2t and 2t+1, which the lane already
// holds), and V's rows are read in the same order.  The 16 x D output
// accumulator stays in registers.  K and V tiles are double-buffered by
// cp.async (16-byte copies where rows are 16-byte aligned, 4-byte ones
// otherwise; ragged kv rows and the columns past D are zero-filled by the
// copy, so no garbage reaches P V), one barrier per kv tile.  D is
// zero-padded to DP = 32, 64 or 128 in shared memory (a template argument,
// so no loop tests D), and rows are DP + 4 floats long, so that ldmatrix
// and the transposed reads of V hit 32 distinct banks.  The block skips
// dead kv tiles by the TPU kernel's predicate on its 64 rows, and each
// warp, by the same predicate on its own 16 rows, skips the products of
// tiles that are dead for it, which leaves ~1.1x the live pairs on the
// causal diagonal where whole-block tiles left 1.25x.  Two S tiles per n8
// tile (more mma chains), 8 output tiles per P V pass, and one kv buffer
// with 3 blocks an SM (168 registers, which spills) ran no faster or
// within 5% on an H100 (PERF.md, PR 14).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // kv rows per tile
constexpr int NT = BK / 8;      // n8 tiles of S per warp
constexpr int DMAX = 128;       // largest head_dim taken
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int STAGES = 2;       // kv tiles in flight
constexpr int PV_GROUP = 4;     // n8 tiles of O per P V pass
constexpr float NEG_INF = -1e30f;

// rows of DP + 4 floats: q, then each stage's k and v tiles
size_t smem_bytes(int DP) {
  return sizeof(float) * (size_t)(DP + 4) * (BQ + STAGES * 2 * BK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 (or 4) bytes to shared memory; ok = false writes zeros and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small, each a TF32 value in a 32-bit register, both rounded to
// nearest (ties away) by adding half of the 13 bits the mma drops; big is
// masked so that small = x - big is exact (see chunked_ce.cu)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// four 8-row x 4-float tiles, one register each; lanes 8q..8q+7 give the
// row addresses of tile q
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows r0.. of a (rows, D) array with row stride `stride` floats into
// dst [ROWS][LD], columns 0..DP-1, a warp per row and its lanes along it;
// rows past `nrows` and columns past D are zero-filled
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int r0, int nrows,
                                          int D, bool vec, int warp,
                                          int lane) {
  constexpr int LD = DP + 4;
  for (int r = warp; r < ROWS; r += NWARPS) {
    const bool row_ok = r0 + r < nrows;
    const float* row = src + (size_t)(row_ok ? r0 + r : 0) * stride;
    if (vec) {
#pragma unroll
      for (int c = 4 * lane; c < DP; c += 128) {
        const bool ok = row_ok && c < D;
        cp16(dst + r * LD + c, ok ? row + c : src, ok);
      }
    } else {
#pragma unroll
      for (int c = lane; c < DP; c += 32) {
        const bool ok = row_ok && c < D;
        cp4(dst + r * LD + c, ok ? row + c : src, ok);
      }
    }
  }
}

// NKS: 8-deep k-steps of D, which is zero-padded to DP = 8 NKS columns in
// shared memory (32, 64 or 128), and n8 tiles of the output
template <int NKS>
__global__ void __launch_bounds__(NTHREADS, 2)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                int Tq, int Tk, int Hq, int Hkv, int D, float scale,
                int causal, int window, int q_offset, int vec) {
  constexpr int DP = 8 * NKS;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ x LD, scaled q
  float* KV = Qs + BQ * LD;         // STAGES x (K: BK x LD, V: BK x LD)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int t = lane & 3;    // thread in group

  const float* kb = k + ((size_t)b * Tk * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Tk * Hkv + hk) * D;
  const size_t kv_stride = (size_t)Hkv * D;
  auto load_kv = [&](int slot, int kt) {
    float* Ks = KV + slot * 2 * BK * LD;
    load_tile<BK, DP>(Ks, kb, kv_stride, kt * BK, Tk, D, vec, warp, lane);
    load_tile<BK, DP>(Ks + BK * LD, vb, kv_stride, kt * BK, Tk, D, vec, warp,
                      lane);
  };

  // the live kv tiles: the TPU kernel's predicate on rows r_lo..r_hi
  auto live = [&](int kt, int r_lo, int r_hi) {
    const int k0 = kt * BK;
    if (causal && !(k0 <= r_hi + q_offset)) return false;
    if (window && !(k0 + BK - 1 > r_lo + q_offset - window)) return false;
    return true;
  };
  const int nk = (Tk + BK - 1) / BK;
  int kt_lo = 0;
  while (kt_lo < nk && !live(kt_lo, q0, q0 + BQ - 1)) ++kt_lo;
  int kt_hi = kt_lo;
  while (kt_hi < nk && live(kt_hi, q0, q0 + BQ - 1)) ++kt_hi;

  load_tile<BQ, DP>(Qs, q + ((size_t)b * Tq * Hq + h) * D, (size_t)Hq * D,
                    q0, Tq, D, vec, warp, lane);
  if (kt_lo < kt_hi) load_kv(0, kt_lo);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // each warp scales its own 16 rows of q, as the reference does first
  const int w_lo = q0 + 16 * warp;
  for (int i = lane; i < 16 * DP; i += 32) {
    float* p = Qs + (16 * warp + i / DP) * LD + i % DP;
    *p *= scale;
  }
  __syncwarp();

  float m[2] = {NEG_INF, NEG_INF};   // rows g, g + 8
  float l[2] = {0.f, 0.f};           // this lane's part of the row sums
  float acc[NKS][4];
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int qrow[2] = {w_lo + g + q_offset, w_lo + g + 8 + q_offset};

  for (int kt = kt_lo, slot = 0; kt < kt_hi; ++kt, slot ^= 1) {
    cp_wait_all();     // tile kt has landed (this thread's copies)
    __syncthreads();   // ... everyone's; tile kt - 1 is consumed
    if (kt + 1 < kt_hi) load_kv(slot ^ 1, kt + 1);
    cp_commit();
    if (w_lo >= Tq || !live(kt, w_lo, w_lo + 15)) continue;   // warp-uniform

    const float* Ks = KV + slot * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    const int k0 = kt * BK;

    // S = (scale q) k^T, 16 x 32: each 32-deep slice of D summed from zero
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks0 = 0; ks0 < NKS; ks0 += 4) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = ks0; kk < ks0 + 4; ++kk) {
        uint32_t r[4], ab[4], as[4];
        ldsm_x4(r, Qs + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       kk * 8 + (lane >> 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ab[e],
                                               as[e]);
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          ldsm_x4(r, Ks + (8 * j + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 8 + ((lane >> 3) & 1) * 4);
          split_tf32(__uint_as_float(r[0]), bb[j][0], bs[j][0]);
          split_tf32(__uint_as_float(r[1]), bb[j][1], bs[j][1]);
          split_tf32(__uint_as_float(r[2]), bb[j + 1][0], bs[j + 1][0]);
          split_tf32(__uint_as_float(r[3]), bb[j + 1][1], bs[j + 1][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], ab, bs[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], ab, bb[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }

    // mask (unless every (q, k) pair of the warp's tile is live), then the
    // online softmax of rows g and g + 8
    const bool whole = k0 + BK <= Tk &&
                       (!causal || k0 + BK - 1 <= w_lo + q_offset) &&
                       (!window || k0 > w_lo + 15 + q_offset - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = qrow[e >> 1];
          bool ok = kpos < Tk;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && kpos > qpos - window;
          if (!ok) s[j][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // p, split for P V's A operand: k-step j's columns t and t + 4 are kv
    // rows 8j + 2t and 8j + 2t + 1, the two this lane holds
    uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      split_tf32(p[0], pb[j][0], ps[j][0]);   // row g, kv 2t
      split_tf32(p[2], pb[j][1], ps[j][1]);   // row g + 8, kv 2t
      split_tf32(p[1], pb[j][2], ps[j][2]);   // row g, kv 2t + 1
      split_tf32(p[3], pb[j][3], ps[j][3]);   // row g + 8, kv 2t + 1
    }

    // O = alpha O + P V: the tile's 32 kv rows are one slice, summed from
    // zero; PG n8 tiles of the output at a time
    constexpr int PG = PV_GROUP < NKS ? PV_GROUP : NKS;
#pragma unroll
    for (int n0 = 0; n0 < NKS; n0 += PG) {
      float part[PG][4];
#pragma unroll
      for (int n = 0; n < PG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t vb_[PG][2], vs_[PG][2];
        const float* vr = Vs + (8 * j + 2 * t) * LD + n0 * 8 + g;
#pragma unroll
        for (int n = 0; n < PG; ++n) {
          split_tf32(vr[n * 8], vb_[n][0], vs_[n][0]);
          split_tf32(vr[LD + n * 8], vb_[n][1], vs_[n][1]);
        }
#pragma unroll
        for (int n = 0; n < PG; ++n) mma_tf32(part[n], ps[j], vb_[n]);
#pragma unroll
        for (int n = 0; n < PG; ++n) mma_tf32(part[n], pb[j], vs_[n]);
#pragma unroll
        for (int n = 0; n < PG; ++n) mma_tf32(part[n], pb[j], vb_[n]);
      }
#pragma unroll
      for (int n = 0; n < PG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], part[n][e]);
    }
  }

  // the row sums over the 4 lanes of a row; rows past Tq are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = w_lo + g + 8 * i;
    if (tq >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);   // one division a row
    float* out = o + (((size_t)b * Tq + tq) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NKS; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) out[col] = acc[n][2 * i] * inv;
      if (col + 1 < D) out[col + 1] = acc[n][2 * i + 1] * inv;
    }
  }
}

template <int NKS>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* q,
                   const float* k, const float* v, float* o, int Tq, int Tk,
                   int Hq, int Hkv, int D, float scale, int causal,
                   int window, int q_offset, int vec) {
  const size_t smem = smem_bytes(8 * NKS);
  static bool raised = false;   // the >48 KB opt-in, once per instance
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  attn_fwd_kernel<NKS><<<grid, NTHREADS, smem, s>>>(
      q, k, v, o, Tq, Tk, Hq, Hkv, D, scale, causal, window, q_offset, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int attn_fwd(const float* q, const float* k, const float* v,
                        float* o, int B, int Tq, int Tk, int Hq, int Hkv,
                        int D, float scale, int causal, int window,
                        int q_offset, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || D < 1 || D > DMAX || Hkv < 1 ||
      Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  cudaStream_t s = (cudaStream_t)stream;
  const int nks = (D + 7) / 8;
  cudaError_t err;
  if (nks <= 4)
    err = launch<4>(grid, s, q, k, v, o, Tq, Tk, Hq, Hkv, D, scale,
                    causal, window, q_offset, vec);
  else if (nks <= 8)
    err = launch<8>(grid, s, q, k, v, o, Tq, Tk, Hq, Hkv, D, scale,
                    causal, window, q_offset, vec);
  else
    err = launch<16>(grid, s, q, k, v, o, Tq, Tk, Hq, Hkv, D, scale,
                     causal, window, q_offset, vec);
  return (int)err;
}
