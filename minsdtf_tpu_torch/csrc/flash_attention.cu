// Non-causal attention kernels for Hopper (sm_90a): softmax(q k^T * scale) v.
//
// K1 minsdtf_flash_onepass replaces minsdtf_tpu/ops/flash_attention.py
//    _onepass_kernel (whole KV row resident in VMEM, plain softmax, no online
//    correction). On the H100 a KV row does not fit a block's shared memory
//    (K and V at S=4096, d=40 in bf16 are 640 KB), so each block, one per
//    (batch*head, 64-row q tile), sweeps the KV tiles twice: sweep 1 finds the row
//    max of q k^T * scale * log2(e), sweep 2 computes p = exp2(s - m) and
//    accumulates p v and sum(p) in fp32. Nothing is ever rescaled, and the result
//    equals the TPU kernel's up to summation order. As on the TPU, scale * log2(e)
//    is folded into q (rounded to the input type), p is rounded to the V type
//    before the PV product, and sum(p) adds up those ROUNDED p values (the TPU
//    kernel takes the row sum from a ones column appended to V).
//    Bound: at the main-path shape (16, 4096, 40) the work is 4*16*4096^2*40 =
//    42.9 GFLOP on 10.5 MB of input, so it is compute-bound (~43 us at the bf16
//    tensor-core peak); the 2.7e8 exponentials probably cost more on the
//    special-function units than the MMAs do. This simple design spends a third
//    more MMA work (q k^T twice) to avoid any rescaling.
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
// Both kernels: 4 warps; bf16 inputs use WMMA 16x16x16 (mma.sync) tiles with
// fp32 accumulation, fp32 inputs use fp32 FMA. The head dim is zero-padded to a
// multiple of 16 (d=40 -> 48) in shared memory; rows past the sequence ends and
// the ragged KV tail are masked. Inputs are read as strided (B, S, H, D) tensors
// whose D axis is contiguous; the output is written the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

template <typename T, int BQ, int BK, bool ONEPASS>
int launch(const Params& p, cudaStream_t stream) {
  void (*kern)(Params);
  if constexpr (ONEPASS) {
    kern = flash_onepass_kernel<T, BQ, BK>;
  } else {
    kern = flash_online_kernel<T, BQ, BK>;
  }
  const size_t smem = smem_bytes<T, BQ, BK>(p.DP);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
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
// cudaError_t; 0 means the launch was accepted.
extern "C" int minsdtf_flash_onepass(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int Sq, int Sk, int D,
                                     const long long* strides, float scale, int dtype,
                                     void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, 160)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, H, Sq, Sk, D, strides, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16, 64, 64, true>(p, s);
  if (dtype == 0) return launch<float, 64, 64, true>(p, s);
  return (int)cudaErrorInvalidValue;
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
