// Mamba2 SSD scan forward, fp32, for Hopper: the sequential recurrence,
// spread over the card by state rows.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py:mamba2_scan (Pallas
// body _ssd_kernel).  Same function: per (batch b, head h), with the state
// h_t of shape (P, N) in fp32,
//   h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * x_t (outer) B_t
//   y_t = h_t . C_t + D_h * x_t
// where B_t and C_t (N) are shared by every head.  Returns y (B,T,H,P) and
// the final state (B,H,P,N); the initial state is an input.
//
// What bounds it on the H100.  At the slice's shape (B 4, T 256, H 32, P 64,
// N 128) the recurrence is 5*P*N + 3*P flops per (b, h, t) (decay, input
// and output per state element): 1.34 GFLOP, 0.020 ms at the 67 TFLOP/s
// fp32 peak outside the tensor cores; its bytes (x, y, dt, B, C, and the
// state in and out) are ~26 MB, 0.008 ms at 3.35 TB/s.  So fp32 operations
// bound it, and behind them the T-step dependent chain of each state row.
//
// Design.  The TPU kernel walks time chunks in grid order with the state in
// VMEM and does the chunked (matmul) SSD form on the MXU.  Here the exact
// sequential form stays (no exp of a positive number anywhere), and the
// card is filled by splitting the state: row p of h_t needs only x_t[p],
// dt_t, B_t and C_t, so each block owns RP = 32 rows of one (b, h) and
// walks all of T itself, with no reduction between blocks (grid
// B*H*ceil(P/RP); 256 blocks of 256 threads at the slice's shape).  Thread
// (row pair, r) keeps RPT = 2 rows x 8 columns of the state in registers,
// the columns in two runs of 4 (n = 4r.. and 4*tpr + 4r..), so its
// shared-memory reads are float4s on distinct banks, each B_t and C_t value
// read serving two rows; tpr = N/8 threads share a row pair (16 at
// N = 128).  A step is 16 independent state updates and four 4-long
// accumulator chains, then a reduce-scatter over the tpr lanes for y_t (one
// shuffle level halves the rows a lane carries, the rest sum): 5 shuffles
// for 2 rows instead of 8.  Only the state update is carried from step to
// step, so the step loop is unrolled 4x and steps overlap their shuffles.
// Time is staged in chunks of up to 32 steps (B_t, C_t, x_t, dt_t),
// double-buffered with cp.async so that the next chunk is in flight while
// this one is stepped; B_t and C_t are shared by every head and row group
// of a batch row and come from L2.  exp(A_h dt_t) and dt_t x_t[p] are
// computed once per step as a chunk lands, each warp for its own rows, so
// one block barrier per chunk suffices.  The loop ends at T, so a ragged T
// needs no padding.  On an H100 the step loop, not the bound, sets the
// time: each step is a dependent chain of a shared-memory load, the state
// update and the shuffles, and one row pair per thread trades shared-memory
// traffic against warps to hide that chain.

//
// Groups.  The stacked (vmapped) path trains one A and one D per client.
// With `groups` G > 1, A and D are (G, H) and batch row b reads group
// b / (B/G)'s entries; B_t, C_t, x and the state are per batch row
// anyway.  G = 1 reads A[h] and D[h] as before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPT = 8;                   // state columns per thread
constexpr int RPT = 2;                   // state rows per thread
static_assert(RPT == 2, "a step loads its rows' dt*x as one float2");
constexpr int RP = 32;                   // state rows per block
constexpr int MAX_TC = 32;               // time steps per staged chunk
constexpr int UNROLL = 4;                // steps interleaved by the compiler
constexpr int SMEM_BUDGET = 96 * 1024;   // opted in above 48 KB
constexpr int MAX_THREADS = 256;

struct Geometry {
  int tpr;      // threads per state row
  int np;       // padded state width, CPT * tpr
  int rp;       // state rows per block
  int rpp;      // rp rounded up to whole RPT groups
  int threads;  // rpp / RPT * tpr, rounded up to whole warps
  int tc;       // time steps per chunk
  int buf;      // floats of one staging buffer (B, C, x, dt), a multiple of 4
  int smem;     // bytes: two buffers, then dt*x of a chunk and, for each
                // warp, exp(A dt) of a chunk
};

int round4(int n) { return (n + 3) / 4 * 4; }

Geometry geometry(int P, int N) {
  Geometry g;
  g.tpr = 1;
  while (g.tpr * CPT < N) g.tpr <<= 1;
  g.np = CPT * g.tpr;
  // at most MAX_THREADS threads: fewer rows a block for the widest states
  g.rp = P < RP ? P : RP;
  if (g.rp > MAX_THREADS / g.tpr * RPT) g.rp = MAX_THREADS / g.tpr * RPT;
  g.rpp = (g.rp + RPT - 1) / RPT * RPT;
  g.threads = (g.rpp / RPT * g.tpr + 31) / 32 * 32;
  g.tc = MAX_TC;
  for (;; --g.tc) {
    g.buf = round4(g.tc * (2 * g.np + g.rpp + 1));
    g.smem = (2 * g.buf + g.tc * g.rpp + g.threads / 32 * g.tc) *
             (int)sizeof(float);
    if (g.smem <= SMEM_BUDGET || g.tc == 1) break;
  }
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
// ok = false writes a zero and reads nothing (src must still be valid)
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

template <int TPR>
__global__ void __launch_bounds__(MAX_THREADS, 1) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ sT, int T, int H, int P, int N, int rows_per_group,
    Geometry geo, int vec_bc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = CPT * TPR;
  const int rp = geo.rp, rpp = geo.rpp, tc = geo.tc;
  // buffer k: Bs [tc][np], Cs [tc][np], xs [tc][rpp], dts [tc]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* dxs = smem + 2 * geo.buf;   // [tc][rpp]: dt_t * x_t[p]
  // [warp][tc]: exp(A_h dt_t), each warp its own copy
  float* das = dxs + tc * rpp + warp * tc;
  // the rows whose dt_t x_t this warp computes: those of its own lanes
  const int wr0 = min(rpp, warp * (32 / TPR) * RPT);
  const int wrn = min(rpp, wr0 + (32 / TPR) * RPT) - wr0;

  const int blocks_per_head = (P + rp - 1) / rp;
  const int bh = blockIdx.x / blocks_per_head;
  const int p0 = (blockIdx.x % blocks_per_head) * rp;
  const int b = bh / H;
  const int h = bh % H;
  const int r = tid % TPR;
  // rows lr0..lr0+RPT-1 of the block; a thread past the last group (whole
  // warps) reads the last group's inputs, in its own warp, and writes
  // nothing
  const bool group_ok = tid / TPR < rpp / RPT;
  const int lr0 = (group_ok ? tid / TPR : rpp / RPT - 1) * RPT;
  int rows_ok = 0;   // bit i: row lr0 + i exists
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (group_ok && lr0 + i < rp && p0 + lr0 + i < P) rows_ok |= 1 << i;
  const int gh = b / rows_per_group * H + h;   // this row's group, head h
  const float a = A[gh];
  const float dskip = Dskip[gh];
  const int c0 = 4 * r;          // this thread's columns: c0..c0+3 and
  const int c1 = 4 * TPR + c0;   // c1..c1+3

  // the padded columns N..np-1 of B and C stay zero, so their state does
  for (int i = tid; i < tc * (np - N); i += blockDim.x) {
    const int s = i / (np - N);
    const int n = N + i % (np - N);
    smem[s * np + n] = 0.f;
    smem[(tc + s) * np + n] = 0.f;
    smem[geo.buf + s * np + n] = 0.f;
    smem[geo.buf + (tc + s) * np + n] = 0.f;
  }

  auto stage = [&](int k, int t0) {
    const int steps = min(tc, T - t0);
    float* Bs = smem + k * geo.buf;
    float* Cs = Bs + tc * np;
    float* xs = Cs + tc * np;
    float* dts = xs + tc * rpp;
    const size_t bt0 = (size_t)b * T + t0;
    if (vec_bc) {
      const int q4 = N / 4;
      for (int i = tid; i < steps * q4; i += blockDim.x) {
        const int s = i / q4;
        const int n = (i - s * q4) * 4;
        cp16(Bs + s * np + n, Bm + (bt0 + s) * N + n);
        cp16(Cs + s * np + n, Cm + (bt0 + s) * N + n);
      }
    } else {
      for (int i = tid; i < steps * N; i += blockDim.x) {
        const int s = i / N;
        const int n = i - s * N;
        cp4(Bs + s * np + n, Bm + (bt0 + s) * N + n, true);
        cp4(Cs + s * np + n, Cm + (bt0 + s) * N + n, true);
      }
    }
    for (int i = tid; i < steps * rpp; i += blockDim.x) {
      const int s = i / rpp;
      const int l = i - s * rpp;
      const bool ok = l < rp && p0 + l < P;
      cp4(xs + i, ok ? x + ((bt0 + s) * H + h) * P + p0 + l : x, ok);
    }
    for (int i = tid; i < steps; i += blockDim.x)
      cp4(dts + i, dt + (bt0 + i) * H + h, true);
  };

  float st[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = (j < 4 ? c0 : c1 - 4) + j;
      st[i][j] = ((rows_ok >> i & 1) && n < N)
                     ? s0[((size_t)bh * P + p0 + lr0 + i) * N + n]
                     : 0.f;
    }

  // y_t of the RPT rows: a reduce-scatter over the TPR lanes of the group.
  // While a lane carries more than one row, each shuffle level halves them
  // (the lane with that bit set keeps the upper half); the remaining levels
  // sum.  A lane ends with NV whole row sums, rows lr0 + base ...; where
  // lanes hold the same sums, the one with the summing bits 0 writes it.
  constexpr int NV = TPR >= RPT ? 1 : RPT / TPR;
  int base = 0;
#pragma unroll
  for (int off = TPR / 2, nv = RPT; off > 0 && nv > 1; off >>= 1, nv >>= 1)
    if (r & off) base += nv / 2;
  const bool writer = TPR <= RPT || (r & (TPR / RPT - 1)) == 0;

  stage(0, 0);
  cp_commit();
  for (int t0 = 0, k = 0; t0 < T; t0 += tc, k ^= 1) {
    const int steps = min(tc, T - t0);
    cp_wait_all();    // this chunk has landed (this thread's copies)
    __syncthreads();  // ... everyone's; the last chunk's reads are done
    if (t0 + tc < T) stage(k ^ 1, t0 + tc);
    cp_commit();

    const float* Bs = smem + k * geo.buf;
    const float* Cs = Bs + tc * np;
    const float* xs = Cs + tc * np;
    const float* dts = xs + tc * rpp;
    // once per step, not per thread: exp(A_h dt_t) by each warp, and
    // dt_t x_t[p] by the warp that owns row p, so a warp barrier suffices
    for (int i = lane; i < steps; i += 32) das[i] = expf(a * dts[i]);
    for (int i = lane; i < steps * wrn; i += 32) {
      const int s = i / wrn;
      const int l = s * rpp + wr0 + (i - s * wrn);
      dxs[l] = dts[s] * xs[l];
    }
    __syncwarp();

    const size_t bt0 = (size_t)b * T + t0;
    auto step = [&](int s) {
      const float da = das[s];
      const float2 d2 = *reinterpret_cast<const float2*>(dxs + s * rpp + lr0);
      const float dx[RPT] = {d2.x, d2.y};
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + s * np + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + s * np + c1);
      const float4 q0 = *reinterpret_cast<const float4*>(Cs + s * np + c0);
      const float4 q1 = *reinterpret_cast<const float4*>(Cs + s * np + c1);
      const float bv[CPT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float cv[CPT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float v[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          st[i][j] = fmaf(da, st[i][j], dx[i] * bv[j]);
        // two independent 4-long chains
        float acc0 = st[i][0] * cv[0];
        float acc1 = st[i][4] * cv[4];
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          acc0 = fmaf(st[i][j], cv[j], acc0);
          acc1 = fmaf(st[i][4 + j], cv[4 + j], acc1);
        }
        v[i] = acc0 + acc1;
      }
#pragma unroll
      for (int off = TPR / 2, nv = RPT; off > 0; off >>= 1) {
        if (nv > 1) {
          const bool up = r & off;
#pragma unroll
          for (int i = 0; i < nv / 2; ++i) {
            const float send = up ? v[i] : v[nv / 2 + i];
            const float keep = up ? v[nv / 2 + i] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          nv >>= 1;
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
        }
      }
      if (writer) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int lr = lr0 + base + i;
          if (rows_ok >> (base + i) & 1)
            y[((bt0 + s) * H + h) * P + p0 + lr] =
                fmaf(dskip, xs[s * rpp + lr], v[i]);
        }
      }
    };
    // a fixed trip count, so that UNROLL steps really interleave (a loop
    // with shuffles and a runtime count is not unrolled)
    int s = 0;
    for (; s + UNROLL <= steps; s += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step(s + u);
    }
    for (; s < steps; ++s) step(s);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = (j < 4 ? c0 : c1 - 4) + j;
      if ((rows_ok >> i & 1) && n < N)
        sT[((size_t)bh * P + p0 + lr0 + i) * N + n] = st[i][j];
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All tensors fp32, contiguous:
// x (B,T,H,P), dt (B,T,H), A and D (groups,H), Bm and Cm (B,T,N), s0 and
// sT (B,H,P,N), y (B,T,H,P); `groups` divides B.  ssd_supported says
// whether (P, N) fits the block (1 if so): N up to 256, any P.  ssd_fwd
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ssd_supported(int P, int N) {
  if (P < 1 || N < 1) return 0;
  const Geometry g = geometry(P, N);
  return g.tpr <= 32 && g.smem <= SMEM_BUDGET;
}

extern "C" int ssd_fwd(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* s0, float* y, float* sT, int B, int T,
                       int H, int P, int N, int groups, void* stream) {
  if (B < 1 || T < 1 || H < 1 || groups < 1 || B % groups ||
      !ssd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(P, N);
  const int vec_bc = N % 4 == 0 && (uintptr_t)Bm % 16 == 0 &&
                     (uintptr_t)Cm % 16 == 0;
  const long long blocks = (long long)B * H * ((P + g.rp - 1) / g.rp);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<32>;
  switch (g.tpr) {
    case 1: kernel = ssd_scan_kernel<1>; break;
    case 2: kernel = ssd_scan_kernel<2>; break;
    case 4: kernel = ssd_scan_kernel<4>; break;
    case 8: kernel = ssd_scan_kernel<8>; break;
    case 16: kernel = ssd_scan_kernel<16>; break;
  }
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, g.threads, g.smem, (cudaStream_t)stream>>>(
      x, dt, A, Bm, Cm, D, s0, y, sT, T, H, P, N, B / groups, g, vec_bc);
  return (int)cudaGetLastError();
}
