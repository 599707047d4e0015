// Chunked cross-entropy forward over a large vocabulary, fp32 in and out,
// on Hopper's tensor cores with a 3xTF32 split.
//
// Replaces the TPU kernel src/repro/kernels/chunked_ce.py:chunked_cross_entropy
// (Pallas body _ce_kernel).  Same function: per token row of
// hidden (N,D) @ lm_head (D,V), the NLL logsumexp(logits) - logits[label] by
// an online logsumexp over vocab tiles, with the vocab and token tails masked
// and labels below 0 giving 0.  The (N, V) logits never exist in device
// memory.  The mean over valid rows is taken by the caller.
//
// Precision.  The inputs are fp32 and the loss must match an fp32 product.
// Plain TF32 keeps 10 mantissa bits and would not.  So each operand element
// x is split as it leaves shared memory into big = tf32(x) and
// small = tf32(x - big), both rounded to nearest, and the kernel sums
// small*big + big*small + big*big on the tensor cores into fp32
// accumulators (CUTLASS calls this OpMultiplyAddFastF32).  Only
// small*small, ~2^-22 of each product, is dropped: about the rounding of an
// fp32 product.  The tensor cores truncate as they accumulate, so each
// 32-deep k slice is summed into a fresh register tile and added to the
// running sum with one rounded fp32 add.
//
// What bounds it on the H100: the three TF32 products.  At the slice's shape
// (N=B*T=1024, D=3584, V=152064) they are 3 * 2*N*D*V = 3.35 TFLOP, 6.8 ms at
// the 495 TFLOP/s dense TF32 peak, against 2.2 GB of lm_head (0.65 ms at
// 3.35 TB/s).  The fp32 product outside the tensor cores would take 16.7 ms
// at 67 TFLOP/s.
//
// Design.  The TPU grid is (token tiles, vocab tiles) with the vocab axis
// innermost and sequential, carrying m/l/gold in VMEM.  Hopper has no
// sequential grid axis, so the grid is split over the vocab: block
// (token tile, vocab tile) computes one 128x128 logits tile and reduces it
// at once to a partial (max, sum-exp, gold) per row, written to a small
// [row][vocab tile] array; a second pass (one warp per row) folds the
// partials with the same online rule and writes the row's NLL.  The token
// tile is the fastest grid index, so the blocks sharing one lm_head tile
// run together and read it from L2 rather than device memory.
//   The tile product: 8 warps (2 x 4), each a 64x32 warp tile of
// mma.sync.m16n8k8 tf32 products.  A ring of STAGES shared-memory stages,
// each a 32-deep k slice of both operands, is filled by cp.async (16-byte
// copies where rows are 16-byte aligned, 4-byte ones otherwise; a ragged
// N, D or V is zero-filled by the copy), so the next slices are in flight
// while this one is multiplied; one barrier per slice.  Rows are padded so
// that every fragment load of a warp (ldmatrix for the k-contiguous tiles)
// hits 32 distinct banks.  The split is four integer or float operations
// per element.
//   mma.sync, not wgmma: its fragments are loaded by the threads from shared
// memory in any layout, so one kernel serves the untied (D, V) head, whose
// tile is N-major, and the tied (V, D) table, whose tile is K-major.
// wgmma with tf32 takes both operands K-major only.  On an H100 this
// design runs at about 2.6x its bound: mma.sync issues TF32 products well
// below the rate wgmma reaches, and neither a shared-memory split of hidden
// (done once per slice instead of by each warp) nor other slice or ring
// depths changed its time there.
//
// Groups.  The stacked (vmapped) path trains one head per client.  With
// `groups` G > 1 the N rows are G runs of N/G, and run g multiplies its
// own head, the g-th (D, V) matrix (or (V, D) table) of a (G, ...) stack:
// grid axis z is the group and moves every pointer by its run (rows, head,
// labels, partials), so a row tile never straddles two groups.  G = 1 is
// the one-head kernel, instruction for instruction.
//
// Tied heads.  A model that ties its head to the embedding passes
// lm_head = embed.T, a (D, V) view of the row-major (V, D) table.  The
// `head_is_vd` flag reads that table in place (a column tile of the head is
// a row tile of the table, k contiguous) rather than copying 4*V*D bytes
// per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // token rows per block
constexpr int BN = 128;        // vocab columns per block
constexpr int BK = 32;         // k slice per pipeline stage
constexpr int STAGES = 4;      // depth of the cp.async ring
constexpr int NTHREADS = 256;  // 8 warps: 2 along the rows x 4 along vocab
constexpr int WM = 64;         // warp tile rows
constexpr int WN = 32;         // warp tile columns
constexpr int MT = WM / 16;    // m16 tiles per warp
constexpr int NT = WN / 8;     // n8 tiles per warp
constexpr int KPAD = BK + 4;   // stride of a k-contiguous tile row: 36 floats
constexpr int NPAD = BN + 8;   // stride of a vocab-contiguous tile row: 136
constexpr int A_TILE = BM * KPAD;      // hidden: [row][k]
constexpr int B_TILE_KV = BK * NPAD;   // (D, V) head: [k][col]
constexpr int B_TILE_VD = BN * KPAD;   // (V, D) table: [col][k]
constexpr float NEG_INF = -1e30f;
static_assert(BM == BN, "load_k_tile moves BM rows of hidden or the table");

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
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = big + small, each a TF32 value in a 32-bit register.  The mma reads
// only the top 19 bits of a tf32 register (sign, exponent, 10 mantissa
// bits) and drops the other 13, so adding half of the dropped range rounds
// to nearest (ties away): big is rounded and masked, so that small = x - big
// is exact, and small is rounded the same way.  Four integer or float
// operations in all; two cvt.rna.tf32.f32 compile to many more on sm_90a.
// Finite inputs only: an fp32 within half a TF32 step of FLT_MAX rounds to
// inf.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// four 8x8 b16 matrices = four 8-row x 4-float tiles, one register each;
// lanes 8q..8q+7 give the row addresses of tile q
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

// rows x BK k-contiguous tile from a row-major (rows, D) array: hidden, or
// the (V, D) table of a tied head
template <bool kVec>
__device__ __forceinline__ void load_k_tile(float* dst, const float* src,
                                            int r0, int nrows, int k0, int D,
                                            int tid) {
  if (kVec) {
#pragma unroll
    for (int it = 0; it < (BM * BK / 4) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int r = idx / (BK / 4);
      const int k = (idx % (BK / 4)) * 4;
      const bool ok = r0 + r < nrows && k0 + k < D;
      cp16(dst + r * KPAD + k, ok ? src + (size_t)(r0 + r) * D + k0 + k : src,
           ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (BM * BK) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const bool ok = r0 + r < nrows && k0 + k < D;
      cp4(dst + r * KPAD + k, ok ? src + (size_t)(r0 + r) * D + k0 + k : src,
          ok);
    }
  }
}

// BK x BN vocab-contiguous tile of the row-major (D, V) head
template <bool kVec>
__device__ __forceinline__ void load_v_tile(float* dst, const float* w,
                                            int col0, int k0, int D, int V,
                                            int tid) {
  if (kVec) {
#pragma unroll
    for (int it = 0; it < (BK * BN / 4) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int k = idx / (BN / 4);
      const int c = (idx % (BN / 4)) * 4;
      const bool ok = k0 + k < D && col0 + c < V;
      cp16(dst + k * NPAD + c, ok ? w + (size_t)(k0 + k) * V + col0 + c : w,
           ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (BK * BN) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int k = idx / BN;
      const int c = idx % BN;
      const bool ok = k0 + k < D && col0 + c < V;
      cp4(dst + k * NPAD + c, ok ? w + (size_t)(k0 + k) * V + col0 + c : w,
          ok);
    }
  }
}

template <bool kVD>
__host__ __device__ constexpr int stage_floats() {
  return A_TILE + (kVD ? B_TILE_VD : B_TILE_KV);
}

// kVD: w is the (V, D) row-major table of a tied head (lm_head = table.T);
// otherwise w is the (D, V) row-major head.  kVec: every row of h and w
// starts 16-byte aligned, so the tiles move in 16-byte copies.
template <bool kVD, bool kVec>
__global__ void __launch_bounds__(NTHREADS, 1)
ce_partial_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const int* __restrict__ labels, float* __restrict__ pm,
                  float* __restrict__ pl, float* __restrict__ pg, int N,
                  int D, int V, int nvt) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = stage_floats<kVD>();

  // group blockIdx.z: its N rows, its head, its labels and partials
  h += (size_t)blockIdx.z * N * D;
  w += (size_t)blockIdx.z * D * V;
  labels += (size_t)blockIdx.z * N;
  const size_t pofs = (size_t)blockIdx.z * N * nvt;
  pm += pofs;
  pl += pofs;
  pg += pofs;

  const int row0 = blockIdx.x * BM;
  const int vt = blockIdx.y;
  const int col0 = vt * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / (BN / WN);   // 0..1
  const int wn = warp % (BN / WN);   // 0..3
  const int g = lane >> 2;           // mma group
  const int t = lane & 3;            // thread in group

  auto load_stage = [&](int slot, int k0) {
    float* As = smem + slot * STAGE;
    float* Bs = As + A_TILE;
    load_k_tile<kVec>(As, h, row0, N, k0, D, tid);
    if (kVD)
      load_k_tile<kVec>(Bs, w, col0, V, k0, D, tid);
    else
      load_v_tile<kVec>(Bs, w, col0, k0, D, V, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();   // slice kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and slice kt-1 is consumed
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next * BK);
    cp_commit();

    const float* As = smem + (kt % STAGES) * STAGE;
    const float* Bs = As + A_TILE;
    // this slice's sum starts from zero and joins acc with one rounded add:
    // the tensor cores truncate as they accumulate, so 1344 mma into one
    // accumulator (D 3584) drift to 15x an fp32 product's error per row on
    // an H100; 12 mma into a fresh tile do not
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t bb[NT][2], bs[NT][2];
      if (kVD) {   // [col][k], k contiguous: two n8 tiles per ldmatrix
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, Bs + (wn * WN + j * 8 + (lane & 7) + (lane >> 4) * 8) *
                              KPAD + ks + ((lane >> 3) & 1) * 4);
          split_tf32(__uint_as_float(r[0]), bb[j][0], bs[j][0]);
          split_tf32(__uint_as_float(r[1]), bb[j][1], bs[j][1]);
          split_tf32(__uint_as_float(r[2]), bb[j + 1][0], bs[j + 1][0]);
          split_tf32(__uint_as_float(r[3]), bb[j + 1][1], bs[j + 1][1]);
        }
      } else {     // [k][col], col contiguous: a transposed read per element
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn * WN + j * 8 + g;
          split_tf32(Bs[(ks + t) * NPAD + c], bb[j][0], bs[j][0]);
          split_tf32(Bs[(ks + t + 4) * NPAD + c], bb[j][1], bs[j][1]);
        }
      }
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t r[4];
        ldsm_x4(r, As + (wm * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            KPAD + ks + (lane >> 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ab[i][e],
                                               as[i][e]);
      }
      // each product over the whole warp tile before the next, so that
      // no mma waits on the one before it
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bb[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the row partials

  // epilogue: each warp reduces its 32 columns to (max, sum-exp, gold) per
  // row with a 4-lane shuffle; then one thread per row folds the 4 warps
  float* red = smem;   // [wn][row][3]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * WM + i * 16 + g + half * 8;
      const int gr = row0 + lr;
      const int lbl = gr < N ? labels[gr] : -1;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + wn * WN + j * 8 + 2 * t + e < V)
            mx = fmaxf(mx, acc[i][j][half * 2 + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float se = 0.f, gold = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = col0 + wn * WN + j * 8 + 2 * t + e;
          const float v = acc[i][j][half * 2 + e];
          if (gc < V) {
            se += expf(v - mx);
            if (gc == lbl) gold += v;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, off);
        gold += __shfl_xor_sync(0xffffffffu, gold, off);
      }
      if (t == 0) {
        float* r = red + (wn * BM + lr) * 3;
        r[0] = mx;
        r[1] = se;
        r[2] = gold;
      }
    }
  }
  __syncthreads();
  if (tid < BM && row0 + tid < N) {
    float M = NEG_INF, L = 0.f, G = 0.f;
#pragma unroll
    for (int q = 0; q < BN / WN; ++q) {
      const float* r = red + (q * BM + tid) * 3;
      const float mn = fmaxf(M, r[0]);
      L = L * expf(M - mn) + r[1] * expf(r[0] - mn);
      M = mn;
      G += r[2];
    }
    const size_t o = (size_t)(row0 + tid) * nvt + vt;
    pm[o] = M;
    pl[o] = L;
    pg[o] = G;
  }
}

// one warp per row: fold the row's vocab-tile partials
__global__ void ce_combine_kernel(const float* __restrict__ pm,
                                  const float* __restrict__ pl,
                                  const float* __restrict__ pg,
                                  const int* __restrict__ labels,
                                  float* __restrict__ nll, int N, int nvt) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // warp-uniform
  float M = NEG_INF, L = 0.f, G = 0.f;
  for (int t = lane; t < nvt; t += 32) {
    const size_t o = (size_t)row * nvt + t;
    const float m = pm[o];
    const float mn = fmaxf(M, m);
    L = L * expf(M - mn) + pl[o] * expf(m - mn);
    M = mn;
    G += pg[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float Mo = __shfl_xor_sync(0xffffffffu, M, off);
    const float Lo = __shfl_xor_sync(0xffffffffu, L, off);
    const float Go = __shfl_xor_sync(0xffffffffu, G, off);
    const float mn = fmaxf(M, Mo);
    L = L * expf(M - mn) + Lo * expf(Mo - mn);
    M = mn;
    G += Go;
  }
  if (lane == 0) {
    const float logz = M + logf(fmaxf(L, 1e-30f));
    nll[row] = labels[row] >= 0 ? logz - G : 0.f;
  }
}

template <bool kVD, bool kVec>
cudaError_t launch_partial(dim3 grid, cudaStream_t s, const float* h,
                           const float* w, const int* labels, float* pm,
                           float* pl, float* pg, int N, int D, int V,
                           int nvt) {
  constexpr int bytes = STAGES * stage_floats<kVD>() * (int)sizeof(float);
  static_assert(bytes <= 227 * 1024, "ring exceeds a block's shared memory");
  static_assert((BN / WN) * BM * 3 <= STAGES * stage_floats<kVD>(),
                "row partials must fit in the ring");
  static bool raised = false;   // the >48 KB opt-in, once per instance
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_partial_kernel<kVD, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  ce_partial_kernel<kVD, kVec><<<grid, NTHREADS, bytes, s>>>(
      h, w, labels, pm, pl, pg, N, D, V, nvt);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `partials` holds 3*N*nvt floats
// (nvt = ceil(V/128), see ce_num_vocab_tiles); `nll` holds N floats.
// `head_is_vd` = 0: w is the (D, V) row-major head; 1: w is a (V, D)
// row-major table and the head is its transpose (tied embeddings).
// `groups` G divides N: rows [g*N/G, (g+1)*N/G) take the g-th of G heads
// stored back to back in w.  Launches on `stream`, does not synchronise,
// returns the launch's error.
extern "C" int ce_num_vocab_tiles(int V) { return (V + BN - 1) / BN; }

extern "C" int ce_fwd(const float* h, const float* w, const int* labels,
                      float* partials, float* nll, int N, int D, int V,
                      int head_is_vd, int groups, void* stream) {
  if (N < 1 || D < 1 || V < 1 || groups < 1 || groups > 65535 ||
      N % groups)
    return (int)cudaErrorInvalidValue;
  const int nvt = (V + BN - 1) / BN;
  if (nvt > 65535) return (int)cudaErrorInvalidValue;
  const int Ng = N / groups;   // rows of one group
  float* pm = partials;
  float* pl = pm + (size_t)N * nvt;
  float* pg = pl + (size_t)N * nvt;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((Ng + BM - 1) / BM, nvt, groups);
  const bool aligned = ((uintptr_t)h % 16 == 0) && ((uintptr_t)w % 16 == 0);
  const bool vec = aligned && D % 4 == 0 && (head_is_vd || V % 4 == 0);
  cudaError_t err;
  if (head_is_vd)
    err = vec ? launch_partial<true, true>(grid, s, h, w, labels, pm, pl, pg,
                                           Ng, D, V, nvt)
              : launch_partial<true, false>(grid, s, h, w, labels, pm, pl,
                                            pg, Ng, D, V, nvt);
  else
    err = vec ? launch_partial<false, true>(grid, s, h, w, labels, pm, pl,
                                            pg, Ng, D, V, nvt)
              : launch_partial<false, false>(grid, s, h, w, labels, pm, pl,
                                             pg, Ng, D, V, nvt);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (int)(((size_t)N * 32 + threads - 1) / threads);
  ce_combine_kernel<<<blocks, threads, 0, s>>>(pm, pl, pg, labels, nll, N,
                                               nvt);
  return (int)cudaGetLastError();
}
