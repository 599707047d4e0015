// RWKV6 (Finch) WKV scan forward, fp32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan (Pallas
// body _rwkv6_kernel).  Same function: per (batch b, head h), with the state
// S of shape (D, D) in fp32 and per-channel decay d_t = exp(-exp(w_t)),
//   y_t = r_t (S_{t-1} + diag(u_h) k_t^T v_t)
//   S_t = diag(d_t) S_{t-1} + k_t^T v_t
// Returns y (B,T,H,D) and the final state (B,H,D,D); the initial state is an
// input.  When exp(w) overflows to +inf the decay is exp(-inf) = 0 exactly.
//
// What bounds it on the H100.  At the slice's shape (B 4, T 256, H 64,
// D 64) the least work is 5*D*D + 5*D flops per (b, h, t): r S_{t-1} and
// S = d S + k^T v per state element, and the bonus v_e * sum_d r_d u_d k_d
// per row, 1.35 GFLOP, 0.020 ms at the 67 TFLOP/s fp32 peak.  Its bytes
// (r, k, v, w, y, u, and the state in and out) are ~92 MB, 0.0275 ms at
// 3.35 TB/s, so bytes bound it.  This kernel issues 3 FP32 instructions per
// state element and step (k v, the state update, r S into y), ~170 in all
// per step and thread: at one warp instruction per cycle per scheduler that
// is ~0.05 ms, and the step loop's latency (loads, then the shuffles of
// y's sum) comes on top, since 256 blocks of 4 warps leave 2 warps per
// scheduler.  The decay pass, the per-step dot products and the shuffles
// each add a little; on an H100 it runs at ~3x the byte bound.
//
// Design.  The TPU grid walks time chunks in order with the state in VMEM
// and steps sequentially inside each chunk (the per-channel decay makes a
// chunked matmul form unsafe; the reference keeps the sequential form, and
// so does this kernel).  Hopper has no sequential grid axis, so one block
// per (b, h) walks all of T itself; the state never leaves registers.
//   Each thread owns an RPT x CPT = 8 x 4 tile of the state: 8 rows in two
// contiguous runs of 4 (4g.. and 4g + 4 GP.. for row group g of GP, so
// that the lanes' loads hit distinct banks) and 4 contiguous columns
// (column group cg).  So r_t, k_t and the decay of its rows arrive as two
// float4 shared-memory loads each and serve all 4 columns, and v_t as one
// float4: 7 loads for 32 elements, where one column per thread with
// strided rows (the design before) took 3 scalar loads per element.  The
// GP row groups of a column group are neighbouring lanes of one warp
// (GP = 8 at D 64: 128 threads a block), so y_t's sum over d is a
// reduce-scatter over those lanes: two levels halve the 4 columns a lane
// carries, the rest sum (4 shuffles for 4 columns).  The bonus is one dot
// product per step, a_t = sum_d r_d u_d k_d, computed for all steps of a
// chunk at once (a few lanes per step) and added as a_t v_t[e] by the lanes
// of row group 0 before the reduction: 5*D*D + 5*D flops, not the 7*D*D of
// the bonus inside the element loop (it reassociates the sum; the card
// check holds y to float64).  Only S carries from step to step, so steps
// are unrolled 8x and one step's shuffles overlap the next ones'
// arithmetic.
//   Time is staged in chunks of up to 32 steps (r, k, v, w), double-
// buffered with cp.async so that the next chunk is in flight while this one
// is stepped.  When a chunk lands, the block turns w into exp(-exp(w)) in
// place, once per element (four at a time), and computes the chunk's a_t;
// a barrier later the steps start.  Rows past D (up to the GP*8 the lanes
// cover) and columns past D (up to a multiple of 4) are zeros in shared
// memory and in the state, so they add nothing; the loop ends at T, so a
// ragged T needs no padding.  Two columns per thread (twice the warps),
// 2 or 4 unrolled steps and 16-step chunks were all slower on an H100
// (PERF.md, PR 14).

//
// Groups.  The stacked (vmapped) path trains one u per client.  With
// `groups` G > 1, u is (G, H, D) and batch row b reads group b / (B/G)'s
// u_h; G = 1 reads u_h as before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPT = 8;                   // state rows per thread, 2 runs of 4
constexpr int CPT = 4;                   // state columns per thread
constexpr int MAX_TC = 32;               // time steps per staged chunk
constexpr int UNROLL = 8;                // steps interleaved by the compiler
constexpr int MAX_GP = 16;               // row groups: D up to 128
constexpr int SMEM_BUDGET = 96 * 1024;   // opted in above 48 KB

struct Geometry {
  int gp;       // row groups, a power of two: lanes that share a column group
  int dr;       // padded rows, gp * RPT
  int dc;       // padded columns, a multiple of CPT
  int threads;  // dc / CPT column groups x gp lanes, in whole warps
  int tc;       // time steps per chunk
  int al;       // lanes that sum one step's a_t, a power of two <= 32
  int buf;      // floats of one staging buffer, a multiple of 4:
                // r, k, decay [tc][dr], v [tc][dc], a [tc]
  int smem;     // bytes: two buffers, then u [dr]
};

int round4(int n) { return (n + 3) / 4 * 4; }

Geometry geometry(int D) {
  Geometry g;
  g.gp = 1;
  while (g.gp * RPT < D) g.gp <<= 1;
  g.dr = g.gp * RPT;
  g.dc = round4(D);
  const int per_warp = 32 / (g.gp < 32 ? g.gp : 32);
  g.threads = (g.dc / CPT + per_warp - 1) / per_warp * 32;
  g.tc = MAX_TC;
  for (;; --g.tc) {
    g.buf = round4(g.tc * (3 * g.dr + g.dc + 1));
    g.smem = (2 * g.buf + g.dr) * (int)sizeof(float);
    if (g.smem <= SMEM_BUDGET || g.tc == 1) break;
  }
  g.al = 32;
  while (g.al > 1 && g.al * g.tc > g.threads) g.al >>= 1;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// threads of a block at most: 2 GP^2 (D <= 8 GP), at least one warp
constexpr int max_threads(int gp) {
  return 2 * gp * gp < 32 ? 32 : 2 * gp * gp;
}

template <int GP>
__global__ void __launch_bounds__(max_threads(GP), 1) wkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ sT, int T, int H, int D,
    int rows_per_group, Geometry geo, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DR = GP * RPT;
  const int dc = geo.dc, tc = geo.tc, buf = geo.buf;
  float* us = smem + 2 * buf;   // u_h, zero past D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane % GP;                           // row group
  const int ncg = dc / CPT;
  const int cg_raw = warp * (32 / GP) + lane / GP;   // column group
  const bool cg_ok = cg_raw < ncg;
  const int cg = cg_ok ? cg_raw : ncg - 1;   // a spare lane reads, never writes
  // this thread's rows: two runs of 4, d0.. and DR/2 + d0.., so that the
  // GP lanes' float4 loads of a step's r, k and decay hit distinct banks
  const int d0 = g * 4;
  const int e0 = cg * CPT;
  auto row = [&](int j) { return (j < 4 ? d0 : DR / 2 + d0 - 4) + j; };

  // the padding rows of r, k, decay and columns of v stay zero
  for (int i = tid; i < 2 * tc * (DR - D); i += blockDim.x) {
    const int s = i / (DR - D);
    const int d = D + i % (DR - D);
    float* base = smem + (s >= tc ? buf : 0);
    const int st = s % tc;
    base[st * DR + d] = 0.f;
    base[(tc + st) * DR + d] = 0.f;
    base[(2 * tc + st) * DR + d] = 0.f;
  }
  for (int i = tid; i < 2 * tc * (dc - D); i += blockDim.x) {
    const int s = i / (dc - D);
    float* vs = smem + (s >= tc ? buf : 0) + 3 * tc * DR;
    vs[(s % tc) * dc + D + i % (dc - D)] = 0.f;
  }
  const float* uh = u + ((size_t)(b / rows_per_group) * H + h) * D;
  for (int d = tid; d < DR; d += blockDim.x) us[d] = d < D ? uh[d] : 0.f;

  auto stage = [&](int kb, int t0) {
    const int steps = min(tc, T - t0);
    float* rs = smem + kb * buf;
    float* ks = rs + tc * DR;
    float* ds = ks + tc * DR;
    float* vs = ds + tc * DR;
    const size_t bt0 = (size_t)b * T + t0;
    if (vec) {
      const int q4 = D / 4;
      for (int i = tid; i < steps * q4; i += blockDim.x) {
        const int s = i / q4;
        const int d = (i - s * q4) * 4;
        const size_t gi = ((bt0 + s) * H + h) * D + d;
        cp16(rs + s * DR + d, r + gi);
        cp16(ks + s * DR + d, k + gi);
        cp16(ds + s * DR + d, w + gi);
        cp16(vs + s * dc + d, v + gi);
      }
    } else {
      for (int i = tid; i < steps * D; i += blockDim.x) {
        const int s = i / D;
        const int d = i - s * D;
        const size_t gi = ((bt0 + s) * H + h) * D + d;
        cp4(rs + s * DR + d, r + gi);
        cp4(ks + s * DR + d, k + gi);
        cp4(ds + s * DR + d, w + gi);
        cp4(vs + s * dc + d, v + gi);
      }
    }
  };

  float st[RPT][CPT];
  const size_t sbase = (size_t)bh * D * D;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int d = row(j);
    if (vec && d < D && cg_ok) {
      const float4 q = *reinterpret_cast<const float4*>(s0 + sbase +
                                                        (size_t)d * D + e0);
      st[j][0] = q.x; st[j][1] = q.y; st[j][2] = q.z; st[j][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        st[j][c] = (d < D && cg_ok && e0 + c < D)
                       ? s0[sbase + (size_t)d * D + e0 + c] : 0.f;
    }
  }

  // y_t of the 4 columns: a reduce-scatter over the GP lanes of the column
  // group.  While a lane carries more than one column, each shuffle level
  // halves them (the lane with that bit set keeps the upper half); the
  // remaining levels sum.  A lane ends with NV whole sums, columns
  // e0 + base ...; where lanes hold the same sums, the one with the
  // summing bits 0 writes them.
  constexpr int NV = GP >= CPT ? 1 : CPT / GP;
  int base = 0;
#pragma unroll
  for (int off = GP / 2, nv = CPT; off > 0 && nv > 1; off >>= 1, nv >>= 1)
    if (g & off) base += nv / 2;
  const bool writer = cg_ok && (GP <= CPT || (g & (GP / CPT - 1)) == 0);

  stage(0, 0);
  cp_commit();
  for (int t0 = 0, kb = 0; t0 < T; t0 += tc, kb ^= 1) {
    const int steps = min(tc, T - t0);
    cp_wait_all();    // this chunk has landed (this thread's copies)
    __syncthreads();  // ... everyone's; the last chunk's reads are done
    if (t0 + tc < T) stage(kb ^ 1, t0 + tc);
    cp_commit();

    float* rs = smem + kb * buf;
    float* ks = rs + tc * DR;
    float* ds = ks + tc * DR;
    float* vs = ds + tc * DR;
    float* as = vs + tc * dc;
    // once per element: the decay; once per step: a_t = sum_d r_d u_d k_d
    if (vec) {
      const int q4 = D / 4;
      for (int i = tid; i < steps * q4; i += blockDim.x) {
        const int s = i / q4;
        float4* p = reinterpret_cast<float4*>(ds + s * DR + (i - s * q4) * 4);
        float4 x = *p;
        x.x = expf(-expf(x.x));
        x.y = expf(-expf(x.y));
        x.z = expf(-expf(x.z));
        x.w = expf(-expf(x.w));
        *p = x;
      }
    } else {
      for (int i = tid; i < steps * D; i += blockDim.x) {
        const int s = i / D;
        float* p = ds + s * DR + (i - s * D);
        *p = expf(-expf(*p));
      }
    }
    // all steps of the chunk at once, al neighbouring lanes per step (the
    // loop's trip count is the block's, so every lane shuffles)
    const int al = geo.al;
    for (int s0 = 0; s0 < steps; s0 += blockDim.x / al) {
      const int s = s0 + tid / al;
      float acc = 0.f;
      if (s < steps)
        for (int d = tid % al; d < D; d += al)
          acc = fmaf(rs[s * DR + d] * us[d], ks[s * DR + d], acc);
      for (int off = al / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (s < steps && tid % al == 0) as[s] = acc;
    }
    __syncthreads();

    const size_t bt0 = (size_t)b * T + t0;
    auto step = [&](int s) {
      const float* rt = rs + s * DR + d0;
      const float* kt = ks + s * DR + d0;
      const float* dt = ds + s * DR + d0;
      const float4 r0 = *reinterpret_cast<const float4*>(rt);
      const float4 r1 = *reinterpret_cast<const float4*>(rt + DR / 2);
      const float4 k0 = *reinterpret_cast<const float4*>(kt);
      const float4 k1 = *reinterpret_cast<const float4*>(kt + DR / 2);
      const float4 q0 = *reinterpret_cast<const float4*>(dt);
      const float4 q1 = *reinterpret_cast<const float4*>(dt + DR / 2);
      const float rr[RPT] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float kk[RPT] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float dd[RPT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float4 vq = *reinterpret_cast<const float4*>(vs + s * dc + e0);
      const float vv[CPT] = {vq.x, vq.y, vq.z, vq.w};
      // the bonus a_t v_t[e] enters once per column, by row group 0
      const float a = g == 0 ? as[s] : 0.f;
      float acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = a * vv[c];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float kv = kk[j] * vv[c];
          acc[c] = fmaf(rr[j], st[j][c], acc[c]);
          st[j][c] = fmaf(dd[j], st[j][c], kv);
        }
#pragma unroll
      for (int off = GP / 2, nv = CPT; off > 0; off >>= 1) {
        if (nv > 1) {
          const bool up = g & off;
#pragma unroll
          for (int i = 0; i < nv / 2; ++i) {
            const float send = up ? acc[i] : acc[nv / 2 + i];
            const float keep = up ? acc[nv / 2 + i] : acc[i];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          nv >>= 1;
        } else {
          acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        }
      }
      if (writer) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int e = e0 + base + i;
          if (e < D) y[((bt0 + s) * H + h) * D + e] = acc[i];
        }
      }
    };
    // a fixed trip count, so that UNROLL steps really interleave (a loop
    // with shuffles and a runtime count is not unrolled)
    int s = 0;
    for (; s + UNROLL <= steps; s += UNROLL) {
#pragma unroll
      for (int uu = 0; uu < UNROLL; ++uu) step(s + uu);
    }
    for (; s < steps; ++s) step(s);
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int d = row(j);
    if (!cg_ok || d >= D) continue;
    if (vec) {
      *reinterpret_cast<float4*>(sT + sbase + (size_t)d * D + e0) =
          make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (e0 + c < D) sT[sbase + (size_t)d * D + e0 + c] = st[j][c];
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All tensors fp32, contiguous:
// r, k, v, w and y (B,T,H,D), u (groups,H,D), s0 and sT (B,H,D,D);
// `groups` divides B.  wkv6_supported says whether D fits the block (1 if
// so): 1 <= D <= 128.  wkv6_fwd launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int wkv6_supported(int D) {
  if (D < 1 || D > MAX_GP * RPT) return 0;
  return geometry(D).smem <= SMEM_BUDGET;
}

extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* y, float* sT, int B, int T, int H, int D,
                        int groups, void* stream) {
  if (B < 1 || T < 1 || H < 1 || groups < 1 || B % groups ||
      !wkv6_supported(D))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(D);
  const bool aligned =
      (uintptr_t)r % 16 == 0 && (uintptr_t)k % 16 == 0 &&
      (uintptr_t)v % 16 == 0 && (uintptr_t)w % 16 == 0 &&
      (uintptr_t)s0 % 16 == 0 && (uintptr_t)sT % 16 == 0;
  const int vec = D % 4 == 0 && aligned;
  auto kernel = wkv6_scan_kernel<16>;
  switch (g.gp) {
    case 1: kernel = wkv6_scan_kernel<1>; break;
    case 2: kernel = wkv6_scan_kernel<2>; break;
    case 4: kernel = wkv6_scan_kernel<4>; break;
    case 8: kernel = wkv6_scan_kernel<8>; break;
  }
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, g.threads, g.smem, (cudaStream_t)stream>>>(
      r, k, v, w, u, s0, y, sT, T, H, D, B / groups, g, vec);
  return (int)cudaGetLastError();
}
