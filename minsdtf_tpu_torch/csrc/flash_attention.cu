// Non-causal attention kernels for Hopper (sm_90a): softmax(q k^T * scale) v.
//
// K1 minsdtf_flash_onepass replaces minsdtf_tpu/ops/flash_attention.py
//    _onepass_kernel: a plain softmax in the exp2 domain over the whole KV row,
//    with scale * log2(e) folded into q (rounded to the input type), p rounded to
//    the V type before the PV product, and sum(p) taken over those ROUNDED p from
//    a ones column appended to V.
//
//    bf16 (the main path; onepass_bf16_kernel<D> for head widths 40, 80, 160):
//    Bound: at the main-path shape (16, 4096, 40) the products are
//    4*16*4096^2*40 = 42.9 GFLOP on 10.5 MB of input, 43 us at the bf16
//    tensor-core peak, but the 2.7e8 exponentials cost more: the special-function
//    units do 16 ex2 per clock per SM, 64 us at 132 SMs and 1.98 GHz. So at d=40
//    the exponentials set the floor, and every other instruction per score
//    (max, subtract, convert, sum) competes with them for issue slots. On the
//    H100 the kernel stays about 2.8x above that floor, and no one pipe binds it
//    (PERF.md).
//    What the design does about it (FlashAttention with wgmma, one online sweep):
//    - One block of two warpgroups (256 threads) per (batch*head, 128-row q
//      tile); each warpgroup owns 64 q rows, the m64 of wgmma. 128 rows per block
//      halve the K/V traffic per score against 64: a block of one warpgroup and
//      64 rows (Tile::WG = 1) measured 1.5x to 1.7x slower at d = 40, 80 and 160,
//      although at (2,1024,8,80) it gives 256 blocks where 128 rows give 128 for
//      132 SMs, one per SM (PERF.md).
//    - Q is loaded once, scaled, rounded to bf16 and held in registers as the
//      wgmma A operand for the whole KV loop (d=40: two k16 steps and a third
//      whose upper 8 columns are zero).
//    - K and V tiles of 64 keys arrive by 16-byte cp.async into a 2-stage ring in
//      shared memory, so tile j + 1 loads while tile j computes; one
//      __syncthreads per tile, after a fence.proxy.async that hands the cp.async
//      writes to wgmma. The tiles lie in core-matrix order (8 keys x 16 bytes in
//      128 contiguous bytes), wgmma's layout without swizzle, which reads each
//      core matrix in one conflict-free pass; each warp's cp.async writes are 512
//      contiguous bytes. The ragged KV tail is zero-filled (src-size 0) and its
//      scores masked to -inf; ragged q rows are zero-filled and not stored.
//    - S = Q K^T runs on wgmma m64n64k16 (K K-major) into fp32 accumulator
//      registers that never go to shared memory. The softmax works on them: the
//      row max over the 4 lanes that share a row (__shfl_xor_sync 1 and 2) and
//      p = exp2(s - m) by ex2.approx.ftz, rounded to bf16 and packed straight into
//      the A operand of P V (the accumulator layout of two n8 column blocks is
//      the k16 A layout).
//    - P V runs on wgmma m64nNk16 with V N-major (transposed B), N = d + 8: every
//      V row carries a 16-byte chunk of bf16 ones after its d values, written once,
//      so the tensor cores add up the rounded p as the TPU kernel's MXU does and
//      no per-score instruction is spent on the row sum. O and the row sum stay in
//      registers.
//    - One online sweep: a running row max m, with O and the row sum rescaled by
//      exp2(m_old - m_new) only when some row of the warp saw its max grow (a warp
//      vote). Two sweeps (row max, then exp2 and P V) compute q k^T twice and
//      measured slower; PERF.md has both times, and those of an mma.sync version
//      of this design. p is rounded relative to the running max, so the result
//      equals the TPU kernel's up to that rounding and the summation order.
//    - Epilogue: O / sum in fp32, rounded to bf16, staged in the warp's own Q rows
//      of shared memory and written out in 16-byte stores.
//    The wrapper sends only d in {40, 80, 160} with 16-byte aligned pointers and
//    strides that are multiples of 8 elements; it zero-pads other widths.
//
//    fp32 (the parity runs; flash_onepass_kernel<float, 64, 64>): each block,
//    one per (batch*head, 64-row q tile), sweeps the KV tiles twice through
//    shared memory: sweep 1 finds the row max of the log2-domain scores, sweep 2
//    computes p = exp2(s - m) and accumulates p v and sum(p) with fp32 FMA.
//
// K2 minsdtf_flash_online replaces minsdtf_tpu/ops/flash_attention.py _kernel
//    (blockwise online softmax over a sequential KV grid axis). Here one block per
//    (batch*head, 32-row q tile) loops over 32-row KV tiles and carries the running
//    max m, sum l and the fp32 accumulator acc with the exp(m_prev - m_new)
//    correction; the result is acc / l. At d = 512 (the VAE mid-block attention,
//    (1, 4096, 512)) a 64 x 512 fp32 accumulator would be 128 KB of registers, so
//    the q tile is cut to 32 rows and acc lives in shared memory (64 KB).
//    Bound: 34.4 GFLOP on 12.6 MB at (1, 4096, 512), compute-bound (~35 us).
//
// K2 and K1's fp32 body: 4 warps; bf16 inputs use WMMA 16x16x16 (mma.sync) tiles
// with fp32 accumulation through shared memory, fp32 inputs use fp32 FMA. The
// head dim is zero-padded to a multiple of 16 (d=40 -> 48) in shared memory; rows
// past the sequence ends and the ragged KV tail are masked. All kernels read
// strided (B, S, H, D) tensors whose D axis is contiguous and write the output
// the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Sk, D, DP;
  // strides in elements of the B, S and H axes; the D axis has stride 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + R) of one (b, h) slice into dst[R][DP], zero past S and D.
// With `mul` != 1 each value is multiplied in fp32 and rounded back to T.
template <typename T, int R>
__device__ void load_tile(T* dst, const T* base, long long s_stride, int row0, int S, int D,
                          int DP, float mul) {
  for (int idx = threadIdx.x; idx < R * DP; idx += NT) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int s = row0 + r;
    T val = from_f<T>(0.f);
    if (s < S && c < D) {
      val = base[(long long)s * s_stride + c];
      if (mul != 1.f) val = from_f<T>(to_f(val) * mul);
    }
    dst[idx] = val;
  }
}

// S[BQ][BK] = Q[BQ][DP] . K[BK][DP]^T in fp32.
template <typename T, int BQ, int BK>
__device__ void qk_tile(const T* Qs, const T* Ks, float* Ss, int DP) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x / 32;
    constexpr int TN = BK / 16;
    for (int t = warp; t < (BQ / 16) * TN; t += NWARPS) {
      const int ti = t / TN, tj = t % TN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + ti * 16 * DP + kk, DP);
        wmma::load_matrix_sync(b, Ks + tj * 16 * DP + kk, DP);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * BK + tj * 16, c, BK, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx - (idx / BK) * BK;
      const T* qr = Qs + i * DP;
      const T* kr = Ks + j * DP;
      float acc = 0.f;
      for (int c = 0; c < DP; ++c) acc = fmaf(qr[c], kr[c], acc);
      Ss[idx] = acc;
    }
  }
}

// Acc[BQ][DP] += P[BQ][BK] . V[BK][DP] in fp32.
template <typename T, int BQ, int BK>
__device__ void pv_tile(const T* Ps, const T* Vs, float* Acc, int DP) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x / 32;
    const int TN = DP / 16;
    for (int t = warp; t < (BQ / 16) * TN; t += NWARPS) {
      const int ti = t / TN, tn = t % TN;
      float* cp = Acc + ti * 16 * DP + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, cp, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + ti * 16 * BK + kk, BK);
        wmma::load_matrix_sync(b, Vs + kk * DP + tn * 16, DP);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, DP, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * DP; idx += NT) {
      const int i = idx / DP, c = idx - (idx / DP) * DP;
      const T* pr = Ps + i * BK;
      float acc = Acc[idx];
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], Vs[j * DP + c], acc);
      Acc[idx] = acc;
    }
  }
}

// Shared memory: Q[BQ][DP] T | KV[BK][DP] T (K, then V of the same tile) |
// S[BQ][BK] f32 | P[BQ][BK] T | Acc[BQ][DP] f32 | m[BQ] f32 | l[BQ] f32.
// Every piece is a multiple of 32 bytes, as WMMA's 256-bit alignment needs.
template <typename T, int BQ, int BK>
__host__ __device__ size_t smem_bytes(int DP) {
  return (size_t)BQ * DP * sizeof(T) + (size_t)BK * DP * sizeof(T) + (size_t)BQ * BK * 4 +
         (size_t)BQ * BK * sizeof(T) + (size_t)BQ * DP * 4 + (size_t)2 * BQ * 4;
}

template <typename T, int BQ, int BK>
struct Smem {
  T* Q;
  T* KV;
  float* S;
  T* P;
  float* Acc;
  float* M;
  float* L;
  __device__ Smem(unsigned char* raw, int DP) {
    Q = reinterpret_cast<T*>(raw);
    KV = Q + BQ * DP;
    S = reinterpret_cast<float*>(KV + BK * DP);
    P = reinterpret_cast<T*>(S + BQ * BK);
    Acc = reinterpret_cast<float*>(P + BQ * BK);
    M = Acc + BQ * DP;
    L = M + BQ;
  }
};

template <typename T, int BQ>
__device__ void init_state(float* Acc, float* M, float* L, int DP) {
  for (int i = threadIdx.x; i < BQ * DP; i += NT) Acc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    M[i] = NEG_BIG;
    L[i] = 0.f;
  }
}

template <typename T, int BQ>
__device__ void store_out(const Params& p, const float* Acc, const float* L, int b, int h,
                          int q0) {
  T* o = reinterpret_cast<T*>(p.o) + b * p.ob + h * p.oh;
  for (int idx = threadIdx.x; idx < BQ * p.DP; idx += NT) {
    const int r = idx / p.DP, c = idx - (idx / p.DP) * p.DP;
    const int s = q0 + r;
    if (s < p.Sq && c < p.D) o[(long long)s * p.os + c] = from_f<T>(Acc[idx] / L[r]);
  }
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT) flash_onepass_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = p.DP;
  Smem<T, BQ, BK> sm(smem_raw, DP);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qg = reinterpret_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = reinterpret_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vg = reinterpret_cast<const T*>(p.v) + b * p.vb + h * p.vh;

  // log2-domain scores: scale * log2(e) folded into q, rounded to T
  load_tile<T, BQ>(sm.Q, qg, p.qs, q0, p.Sq, p.D, DP, p.scale * LOG2E);
  init_state<T, BQ>(sm.Acc, sm.M, sm.L, DP);
  __syncthreads();

  // sweep 1: row max
  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    load_tile<T, BK>(sm.KV, kg, p.ks, k0, p.Sk, p.D, DP, 1.f);
    __syncthreads();
    qk_tile<T, BQ, BK>(sm.Q, sm.KV, sm.S, DP);
    __syncthreads();
    const int nvalid = min(BK, p.Sk - k0);
    for (int r = warp; r < BQ; r += NWARPS) {
      float m = NEG_BIG;
      for (int j = lane; j < nvalid; j += 32) m = fmaxf(m, sm.S[r * BK + j]);
      m = warp_max(m);
      if (lane == 0) sm.M[r] = fmaxf(sm.M[r], m);
    }
    __syncthreads();
  }

  // sweep 2: p = exp2(s - m), acc += p v, l += sum of the rounded p
  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    load_tile<T, BK>(sm.KV, kg, p.ks, k0, p.Sk, p.D, DP, 1.f);
    __syncthreads();
    qk_tile<T, BQ, BK>(sm.Q, sm.KV, sm.S, DP);
    __syncthreads();
    const int nvalid = min(BK, p.Sk - k0);
    for (int r = warp; r < BQ; r += NWARPS) {
      const float m = sm.M[r];
      float l = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const T pj = from_f<T>(j < nvalid ? exp2f(sm.S[r * BK + j] - m) : 0.f);
        sm.P[r * BK + j] = pj;
        l += to_f(pj);
      }
      l = warp_sum(l);
      if (lane == 0) sm.L[r] += l;
    }
    load_tile<T, BK>(sm.KV, vg, p.vs, k0, p.Sk, p.D, DP, 1.f);
    __syncthreads();
    pv_tile<T, BQ, BK>(sm.P, sm.KV, sm.Acc, DP);
    __syncthreads();
  }
  store_out<T, BQ>(p, sm.Acc, sm.L, b, h, q0);
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT) flash_online_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = p.DP;
  Smem<T, BQ, BK> sm(smem_raw, DP);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qg = reinterpret_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = reinterpret_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vg = reinterpret_cast<const T*>(p.v) + b * p.vb + h * p.vh;

  load_tile<T, BQ>(sm.Q, qg, p.qs, q0, p.Sq, p.D, DP, 1.f);
  init_state<T, BQ>(sm.Acc, sm.M, sm.L, DP);
  __syncthreads();

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    load_tile<T, BK>(sm.KV, kg, p.ks, k0, p.Sk, p.D, DP, 1.f);
    __syncthreads();
    qk_tile<T, BQ, BK>(sm.Q, sm.KV, sm.S, DP);
    __syncthreads();
    const int nvalid = min(BK, p.Sk - k0);
    for (int r = warp; r < BQ; r += NWARPS) {
      const float m_prev = sm.M[r];
      float m_cur = NEG_BIG;
      for (int j = lane; j < nvalid; j += 32) m_cur = fmaxf(m_cur, sm.S[r * BK + j] * p.scale);
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      float l = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float pj = j < nvalid ? expf(sm.S[r * BK + j] * p.scale - m_new) : 0.f;
        sm.P[r * BK + j] = from_f<T>(pj);
        l += pj;  // the TPU kernel sums the fp32 p
      }
      l = warp_sum(l);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < DP; c += 32) sm.Acc[r * DP + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sm.M[r] = m_new;
        sm.L[r] = corr * sm.L[r] + l;
      }
    }
    load_tile<T, BK>(sm.KV, vg, p.vs, k0, p.Sk, p.D, DP, 1.f);
    __syncthreads();
    pv_tile<T, BQ, BK>(sm.P, sm.KV, sm.Acc, DP);
    __syncthreads();
  }
  store_out<T, BQ>(p, sm.Acc, sm.L, b, h, q0);
}

// ---- K1, bf16: FlashAttention on wgmma, scores in registers ----

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest even and packed as bf16x2, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr uint32_t BF16_ONES = 0x3F803F80u;  // two bf16 1.0

// A wgmma shared-memory descriptor without swizzle: start address, LBO (the
// stride between core matrices along K) and SBO (along M or N), all in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n88(float (&d)[44], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1, %50;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n168(float (&d)[84], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %89, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83}, "
      "{%84, %85, %86, %87}, %88, p, 1, 1, %90;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// d (m64 x N, fp32) += a (m64 x k16, bf16 registers) . B (k16 x N, bf16 in shared
// memory under `desc`); B is K-major when TRANS_B is 0 and N-major when it is 1.
// scale_d = 0 ignores d's old value.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  if constexpr (N == 64) wgmma_n64<TRANS_B>(d, a, desc, scale_d);
  else if constexpr (N == 48) wgmma_n48<TRANS_B>(d, a, desc, scale_d);
  else if constexpr (N == 88) wgmma_n88<TRANS_B>(d, a, desc, scale_d);
  else if constexpr (N == 168) wgmma_n168<TRANS_B>(d, a, desc, scale_d);
  else static_assert(N == 0, "no wgmma wrapper for this N");
}

template <int D>
struct Tile {
  static constexpr int WG = 2;                            // warpgroups per block
  static constexpr int NT = 128 * WG;                     // threads per block
  static constexpr int BQ = 64 * WG;                      // q rows: 64 per warpgroup
  static constexpr int BK = 64;                           // keys per KV tile
  static constexpr int STAGES = 2;
  static constexpr int NS = BK / 8;                       // score n8 tiles per warp
  static constexpr int CH = D / 8;                        // 16-byte chunks per row
  static constexpr int CHS = CH + 1;                      // K/V chunk slots: + zero / ones
  static constexpr int KSTEPS = (D + 15) / 16;            // k16 steps of q k^T
  static constexpr int NO = CH;                           // output n8 tiles, + the row sum
  static constexpr int NPV = 8 * (NO + 1);                // N of P V
  static constexpr int STR = (CH % 2 ? CH : CH + 1) * 8;  // Q row stride in elements
  static constexpr int KV_BYTES = BK * CHS * 16;          // one K or V tile
  static constexpr int NI = (BK * CH + NT - 1) / NT;      // K (and V) chunks per thread
  static constexpr size_t SMEM = size_t(BQ) * STR * 2 + size_t(2) * STAGES * KV_BYTES;
  static_assert(D % 8 == 0, "tiling");
};

// Rows [row0, row0 + R) of one (b, h) slice into dst[R][STR] by cp.async, zero past S.
template <int R, int CH, int STR, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, long long stride,
                                                int row0, int S) {
#pragma unroll
  for (int i = 0; i < (R * CH + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (R * CH % NT == 0 || idx < R * CH) {
      const int r = idx / CH, c = idx - (idx / CH) * CH;
      const bool valid = row0 + r < S;
      const bf16* g = valid ? src + (long long)(row0 + r) * stride + c * 8 : src;
      cp_async16(smem_u32(dst + r * STR + c * 8), g, valid);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::NT, 1) onepass_bf16_kernel(Params p) {
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::STAGES, STR = T::STR, NS = T::NS, NO = T::NO;
  constexpr int CH = T::CH, CHS = T::CHS, KSTEPS = T::KSTEPS, NT = T::NT, NI = T::NI;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);      // [BQ][STR]; later the output staging
  unsigned char* sK = smem_raw + T::BQ * STR * 2;    // [STAGES][BK / 8][CHS][8][16 bytes]
  unsigned char* sV = sK + STAGES * T::KV_BYTES;     // the same

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * T::BQ;
  const bf16* qg = reinterpret_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kg = reinterpret_cast<const bf16*>(p.k) + b * p.kb + h * p.kh;
  const bf16* vg = reinterpret_cast<const bf16*>(p.v) + b * p.vb + h * p.vh;
  const int ntiles = (p.Sk + BK - 1) / BK;

  // K and V tiles in core-matrix order: 16-byte chunk c of key r at
  // ((r / 8) * CHS + c) * 128 + (r % 8) * 16, so every 8 keys x 16 bytes is one
  // 128-byte block, as wgmma reads it without swizzle. Thread order is shared-memory
  // order (each warp writes 512 contiguous bytes), and each thread copies the same
  // NI (key, chunk) slots of every tile, so their offsets are computed once.
  int slot_key[NI];
  long long koff[NI], voff[NI];
  uint32_t soff[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r8 = idx & 7, t = idx >> 3;
    const int rb = t / CH, c = t - (t / CH) * CH;
    slot_key[i] = (BK * CH % NT == 0 || idx < BK * CH) ? rb * 8 + r8 : BK;
    koff[i] = (long long)(rb * 8 + r8) * p.ks + c * 8;
    voff[i] = (long long)(rb * 8 + r8) * p.vs + c * 8;
    soff[i] = ((rb * CHS + c) * 8 + r8) * 16;
  }
  auto load_kv = [&](int tile) {
    const uint32_t sk = smem_u32(sK + (tile % STAGES) * T::KV_BYTES);
    const uint32_t sv = smem_u32(sV + (tile % STAGES) * T::KV_BYTES);
    const bf16* kt = kg + (long long)tile * BK * p.ks;
    const bf16* vt = vg + (long long)tile * BK * p.vs;
    const int keys = p.Sk - tile * BK;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (slot_key[i] < BK) {
        const bool valid = slot_key[i] < keys;
        cp_async16(sk + soff[i], valid ? kt + koff[i] : kg, valid);
        cp_async16(sv + soff[i], valid ? vt + voff[i] : vg, valid);
      }
    }
  };

  // Q and tile 0 form the first group; tiles 0 .. STAGES-2 are in flight before the loop.
  load_rows_async<T::BQ, CH, STR, NT>(sQ, qg, p.qs, q0, p.Sq);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }
  // The extra chunk slot of every K row is zero (d=40 reads it as d 40..47) and
  // that of every V row is ones (the row-sum column of P V); cp.async never
  // writes either.
  for (int r = threadIdx.x; r < STAGES * BK; r += NT) {
    const int off = (r / BK) * T::KV_BYTES + (((r % BK) / 8 * CHS + CH) * 8 + r % 8) * 16;
    *reinterpret_cast<uint4*>(sK + off) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sV + off) = make_uint4(BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES);
  }

  // Warp w holds q rows 16w .. 16w + 15 of the block: rows 16(w % 4) .. of the
  // 64 rows of warpgroup w / 4, as wgmma's m64 fragments lie.
  const int wrow = warp * 16;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: lane l gives row l % 8 of matrix l / 8

  // Q as wgmma A fragments, with scale * log2(e) folded in and rounded to bf16;
  // at d=40 the last k16 step's upper half is zero.
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const float qscale = p.scale * LOG2E;
  {
    const bf16* rowp = sQ + (wrow + (mi & 1) * 8 + r8) * STR;
#pragma unroll
    for (int ks = 0; ks < CH / 2; ++ks) ldmatrix_x4(qa[ks], smem_u32(rowp + ks * 16 + (mi >> 1) * 8));
    if constexpr (CH % 2) {
      ldmatrix_x2(qa[KSTEPS - 1][0], qa[KSTEPS - 1][1], smem_u32(rowp + (CH / 2) * 16));
      qa[KSTEPS - 1][2] = qa[KSTEPS - 1][3] = 0u;
    }
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qa[ks][i]));
        qa[ks][i] = pack_bf16(f.x * qscale, f.y * qscale);
      }
    }
  }

  // Accumulator fragments: s[j] and o[n] hold columns 8j + 2t, +1 (8n + 2t, +1)
  // of rows g and g + 8 of the warp's 16 rows; o[NO] holds the row sum of the
  // rounded p in every column.
  float s[NS][4], o[NO + 1][4];
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int n = 0; n <= NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  auto& sf = reinterpret_cast<float(&)[BK / 2]>(s);
  auto& of = reinterpret_cast<float(&)[T::NPV / 2]>(o);

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it has landed, and every warp is done with tile it - 1
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    const uint32_t kb = smem_u32(sK + (it % STAGES) * T::KV_BYTES);
    const uint32_t vb = smem_u32(sV + (it % STAGES) * T::KV_BYTES);

    // S = Q K^T; K is K-major: LBO steps to the next 8 of d, SBO to the next 8 keys.
    pin(sf);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      wgmma<BK, 0>(sf, qa[ks], gmma_desc(kb + ks * 256, 128, CHS * 128), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(sf);

    const int k0 = it * BK;
    if (k0 + BK > p.Sk) {  // the ragged tail
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + j * 8 + 2 * (lane & 3) + (e & 1) >= p.Sk) s[j][e] = -INFINITY;
        }
      }
    }

    // Running row max over the 4 lanes of a row; rescale only if some max grew.
    float m_new[2];
    bool grew = false;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = s[0][2 * hh];
#pragma unroll
      for (int j = 0; j < NS; ++j) x = fmaxf(x, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m_new[hh] = fmaxf(m[hh], x);
      grew |= m_new[hh] != m[hh];
    }
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float alpha = m_new[hh] == m[hh] ? 1.f : ex2(m[hh] - m_new[hh]);
        m[hh] = m_new[hh];
#pragma unroll
        for (int n = 0; n <= NO; ++n) {
          o[n][2 * hh] *= alpha;
          o[n][2 * hh + 1] *= alpha;
        }
      }
    }

    // p = exp2(s - m), rounded to bf16 and packed into the A fragments of P V:
    // pa[kk] covers keys 16kk .. 16kk + 15, i.e. score tiles 2kk and 2kk + 1.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pa[j / 2][(j & 1) * 2 + hh] =
            pack_bf16(ex2(s[j][2 * hh] - m[hh]), ex2(s[j][2 * hh + 1] - m[hh]));
    }

    // O += P [V | 1]; V is N-major: LBO steps to the next 8 keys, SBO to the next 8 of d.
    pin(of);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<T::NPV, 1>(of, pa[kk], gmma_desc(vb + kk * 2 * CHS * 128, CHS * 128, 128), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(of);
  }
  cp_async_wait<0>();

  // Epilogue: O / sum into the warp's own Q rows (read only by this warp, before
  // the loop), then 16-byte stores of the rows inside the sequence.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = o[NO][2 * hh];
    bf16* srow = sQ + (wrow + hh * 8 + g) * STR + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(srow + n * 8) = pack_bf16(o[n][2 * hh] / l, o[n][2 * hh + 1] / l);
  }
  __syncwarp();
  bf16* og = reinterpret_cast<bf16*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int i = 0; i < (16 * CH + 31) / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int sq = q0 + wrow + r;
    if ((16 * CH % 32 == 0 || idx < 16 * CH) && sq < p.Sq)
      *reinterpret_cast<uint4*>(og + (long long)sq * p.os + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + (wrow + r) * STR + c * 8);
  }
}

// Lets onepass_bf16_kernel<D> take its shared memory. Set once (a function-local
// static), so no later launch, and no CUDA graph capture, makes the call. The port
// runs on one card: the attribute is set on the device current at the first call.
template <int D>
cudaError_t allow_smem_onepass_bf16() {
  static const cudaError_t err = cudaFuncSetAttribute(
      onepass_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<D>::SMEM);
  return err;
}

template <int D>
int launch_onepass_bf16(const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t err = allow_smem_onepass_bf16<D>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + T::BQ - 1) / T::BQ, p.B * p.H);
  onepass_bf16_kernel<D><<<grid, T::NT, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The bf16 kernel's cp.async and 16-byte stores need 16-byte aligned rows.
bool aligned16(const Params& p, const long long* st) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <int D>
int blocks_per_sm_onepass_bf16() {
  int n = 0;
  if (allow_smem_onepass_bf16<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, onepass_bf16_kernel<D>, Tile<D>::NT,
                                                    Tile<D>::SMEM) != cudaSuccess)
    return 0;
  return n;
}

template <typename T, int BQ, int BK, bool ONEPASS>
int launch(const Params& p, cudaStream_t stream) {
  void (*kern)(Params);
  if constexpr (ONEPASS) {
    kern = flash_onepass_kernel<T, BQ, BK>;
  } else {
    kern = flash_online_kernel<T, BQ, BK>;
  }
  const size_t smem = smem_bytes<T, BQ, BK>(p.DP);
  // Set once, to the most any head width can need (see launch_onepass_bf16).
  static const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<T, BQ, BK>(ONEPASS ? 160 : 512));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kern<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, int D, const long long* st, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.DP = (D + 15) / 16 * 16;
  p.qb = st[0]; p.qs = st[1]; p.qh = st[2];
  p.kb = st[3]; p.ks = st[4]; p.kh = st[5];
  p.vb = st[6]; p.vs = st[7]; p.vh = st[8];
  p.ob = st[9]; p.os = st[10]; p.oh = st[11];
  p.scale = scale;
  return p;
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int max_d) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > max_d || B * H > 65535;
}

}  // namespace

// q, k, v, o: (B, S, H, D) device tensors with the strides in `strides` (12 int64:
// B, S, H strides of q, k, v, o); dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t; 0 means the launch was accepted. K1 in bf16 takes D in {40, 80,
// 160} with 16-byte aligned pointers and strides that are multiples of 8.
extern "C" int minsdtf_flash_onepass(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int Sq, int Sk, int D,
                                     const long long* strides, float scale, int dtype,
                                     void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, 160)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, H, Sq, Sk, D, strides, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!aligned16(p, strides)) return (int)cudaErrorMisalignedAddress;
    if (D == 40) return launch_onepass_bf16<40>(p, s);
    if (D == 80) return launch_onepass_bf16<80>(p, s);
    if (D == 160) return launch_onepass_bf16<160>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch<float, 64, 64, true>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of K1's bf16 kernel at head width D (40, 80 or 160) that one SM holds at
// once, by the CUDA occupancy calculator; 0 on an error.
extern "C" int minsdtf_onepass_bf16_blocks_per_sm(int D) {
  if (D == 40) return blocks_per_sm_onepass_bf16<40>();
  if (D == 80) return blocks_per_sm_onepass_bf16<80>();
  if (D == 160) return blocks_per_sm_onepass_bf16<160>();
  return 0;
}

extern "C" int minsdtf_flash_online(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int D,
                                    const long long* strides, float scale, int dtype,
                                    void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, 512)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, H, Sq, Sk, D, strides, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16, 32, 32, false>(p, s);
  if (dtype == 0) return launch<float, 32, 32, false>(p, s);
  return (int)cudaErrorInvalidValue;
}
