// GroupNorm (+ SiLU) over NHWC activations for Hopper (sm_90a):
// y = (x - mean_g) * rstd_g * gamma_c + beta_c, then y * sigmoid(y) when asked,
// with 32 groups of C / 32 channels, statistics over (H*W, channels of the group)
// of each image, biased variance, rstd = 1 / sqrt(var + eps).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA
// (minsdtf_tpu/ops/basic.py group_norm), which fuses it into the surrounding
// convolutions' layout. The port's plain composition (ops.basic.group_norm_plain:
// a cast to fp32, PyTorch's GroupNorm, a cast back, SiLU's two passes) moves about
// 34 bytes an element and PyTorch's CUDA GroupNorm takes only NCHW, so with
// channels-last activations it adds two transposes around every call. This kernel
// reads bf16 or fp32 NHWC twice and writes once: 6 bytes an element in bf16.
//
// Bound: memory. At (1, 1024*1024, 128) bf16 (the VAE decoder's last level at
// 1024px) the input read twice and the output written once are 805 MB, 0.24 ms at
// 3.35 TB/s; the arithmetic is a few operations an element. What the design does
// about it:
// - Three kernels. group_norm_nhwc_stats_kernel: a grid of (tile of positions,
//   image); each thread owns one 16-byte column of channels (8 bf16 or 4 fp32) and
//   every lanes-th row of the tile, loads UNROLL rows at a time, and sums d = x - K
//   and d^2 over them in fp32, K being the image's first value of the channel;
//   each such sum of UNROLL terms is added into fp64 sums. The block adds its
//   threads' sums into the 32 groups' sum of x and of x^2 in fp64 (a warp a group,
//   a fixed order of adds and shuffles) and writes them to a small fp64 workspace.
//   group_norm_nhwc_finalize_kernel, one block an image, adds every tile's partials
//   in tile order and writes the groups' mean and rstd. A sum of squares in fp32
//   would cancel badly: a group of the VAE's last level at 1024px holds 4M
//   elements, and means sit several spreads from 0. In fp64 about the shift K it
//   does not, and partials merge by addition in a fixed order: the same bits on
//   every run (the step program is held to the step loop bit for bit). A version
//   whose last statistics block did the final sum (an atomic ticket, a memset of
//   the counter in the step's CUDA graph) saved a launch; with it, some profiled
//   images came back short of kernel records (PERF.md).
// - group_norm_nhwc_apply_kernel, the statistics' grid: each block reads its
//   image's 32 (mean, rstd), forms its columns' scale = gamma * rstd and shift =
//   beta - mean * scale in fp64 once, then streams its tile: y = x * scale + shift
//   in fp32, SiLU, one rounding, a 16-byte store. At the UNet's sizes the second
//   read comes from the 50 MB L2.
// - Tiles adapt to the shape (B, H*W, C): one load of UNROLL rows a thread where
//   that keeps the grid under MAX_BLOCKS (each thread waits for memory once), more
//   rows a thread beyond (the 1024px VAE call spreads over MAX_BLOCKS blocks, eight
//   for each SM). Most of the UNet's calls move a few MB: there the three launches
//   and a memory latency each are what cost.
// - A 16-byte column holds 8 (or 4) channels and a group 4 to 80 at the SD1.5
//   widths (10 at 320), so a column may straddle groups: the block's reduction walks
//   channels, not columns, and each channel finds its group by division.
// The wrapper (ops/group_norm.py) sends CUDA bf16 or fp32 tensors whose memory is
// NHWC, dense, 16-byte aligned, with C a multiple of 32 and at most MAX_C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUPS = 32;
constexpr int TARGET_THREADS = 256;
constexpr int MAX_THREADS = 640;   // C = 2560 in fp32: 640 columns of 4
constexpr int MAX_BLOCKS = 1056;   // 8 blocks of 256 threads on each of 132 SMs
constexpr int UNROLL = 4;
constexpr int FINAL_THREADS = 256;  // the finalize kernel: eight lanes of tiles a group
constexpr int MAX_C = 2560;

// 16 bytes of T to and from fp32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// a fixed-order sum over the 32 lanes, every lane gets it
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) v += __shfl_xor_sync(0xffffffffu, v, mask);
  return v;
}

struct Plan {
  int lanes;    // rows a block reads at once: one thread a (row, 16-byte column)
  int threads;  // columns * lanes
  int rows;     // positions of a tile, a multiple of lanes
  int tiles;    // tiles of an image
};

Plan make_plan(int B, int HW, int C, int elem_bytes) {
  const int columns = C * elem_bytes / 16;
  Plan p;
  p.lanes = columns >= TARGET_THREADS ? 1 : TARGET_THREADS / columns;
  p.threads = columns * p.lanes;
  long long tiles = (HW + (long long)p.lanes * UNROLL - 1) / ((long long)p.lanes * UNROLL);
  const long long most = (MAX_BLOCKS + B - 1) / B;
  if (tiles > most) tiles = most;
  if (tiles < 1) tiles = 1;
  long long rows = (HW + tiles - 1) / tiles;
  rows = (rows + p.lanes - 1) / p.lanes * p.lanes;
  p.rows = (int)rows;
  p.tiles = (int)((HW + rows - 1) / rows);
  return p;
}

// The workspace: each image's 32 (mean, rstd), head_doubles(B) doubles; then each
// tile's 32 (sum x, sum x^2).
__host__ __device__ inline long long head_doubles(int B) { return 2LL * GROUPS * B; }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_nhwc_stats_kernel(const T* __restrict__ x, double* __restrict__ ws, int HW, int C,
                             int rows, int lanes) {
  constexpr int V = Vec<T>::N;
  extern __shared__ double smem[];  // sum of x, then sum of x^2, [lanes][C] each
  const int columns = C / V;
  const int col = threadIdx.x % columns, lane = threadIdx.x / columns;
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int r0 = tile * rows, r1 = min(r0 + rows, HW);
  const T* base = x + (long long)b * HW * C + col * V;

  float k[V];
  Vec<T>::load(base, k);  // the shift: the image's first position
  double s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0;
  for (int r = r0 + lane; r < r1; r += lanes * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * lanes < r1) Vec<T>::load(base + (long long)(r + u * lanes) * C, v[u]);
    float c1[V], c2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * lanes < r1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[u][j] - k[j];
          c1[j] += d;
          c2[j] = fmaf(d, d, c2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[j] += c1[j];
      s2[j] += c2[j];
    }
  }
  // this thread's rows: n of them; sum x = s1 + n k, sum x^2 = s2 + 2 k s1 + n k^2
  const int span = r1 - r0;
  const double n = span > lane ? (double)((span - lane + lanes - 1) / lanes) : 0.0;
  double* s_a = smem;
  double* s_q = smem + lanes * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const double kj = k[j];
    s_a[lane * C + col * V + j] = s1[j] + n * kj;
    s_q[lane * C + col * V + j] = s2[j] + kj * (2.0 * s1[j] + n * kj);
  }
  __syncthreads();

  // a warp a group: lane i adds entries i, i + 32, ... of the group's (lane of the
  // block, channel) pairs, then the warp adds its lanes
  const int cpg = C / GROUPS, warps = blockDim.x / 32, wid = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32, entries = cpg * lanes;
  double* part = ws + head_doubles(gridDim.y);
  if (wid >= warps) return;  // the last, partial warp of a block of 240 or 160 threads
  for (int g = wid; g < GROUPS; g += warps) {
    double a = 0.0, q = 0.0;
    for (int e = wlane; e < entries; e += 32) {
      const int i = (e / cpg) * C + g * cpg + e % cpg;
      a += s_a[i];
      q += s_q[i];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (wlane == 0) {
      double* out = part + (((long long)b * tiles + tile) * GROUPS + g) * 2;
      out[0] = a;
      out[1] = q;
    }
  }
}

// One block an image: every tile's partials added in tile order (eight lanes of
// tiles a group, four loads in flight each, then the lanes in order), and the
// groups' mean and rstd written at the head of the workspace.
__global__ void __launch_bounds__(FINAL_THREADS)
group_norm_nhwc_finalize_kernel(double* __restrict__ ws, int HW, int C, int tiles, float eps) {
  __shared__ double red[FINAL_THREADS / 32][GROUPS][2];
  constexpr int PARTS = FINAL_THREADS / 32;
  const int b = blockIdx.x, g = threadIdx.x % 32, which = threadIdx.x / 32;
  const double2* p = reinterpret_cast<const double2*>(ws + head_doubles(gridDim.x)) +
                     (long long)b * tiles * GROUPS + g;
  double a[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};
  int t = which;
  for (; t + 3 * PARTS < tiles; t += 4 * PARTS) {
    double2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = p[(long long)(t + u * PARTS) * GROUPS];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] += v[u].x;
      q[u] += v[u].y;
    }
  }
  for (; t < tiles; t += PARTS) {
    const double2 v = p[(long long)t * GROUPS];
    a[0] += v.x;
    q[0] += v.y;
  }
  red[which][g][0] = (a[0] + a[1]) + (a[2] + a[3]);
  red[which][g][1] = (q[0] + q[1]) + (q[2] + q[3]);
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    double sa = 0.0, sq = 0.0;
    for (int i = 0; i < PARTS; ++i) {
      sa += red[i][g][0];
      sq += red[i][g][1];
    }
    const double count = (double)HW * (C / GROUPS);
    const double mean = sa / count;
    ws[(b * GROUPS + g) * 2] = mean;
    ws[(b * GROUPS + g) * 2 + 1] = rsqrt(fmax(sq / count - mean * mean, 0.0) + (double)eps);
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_nhwc_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                             const double* __restrict__ ws, const float* __restrict__ gamma,
                             const float* __restrict__ beta, int HW, int C, int rows,
                             int lanes) {
  constexpr int V = Vec<T>::N;
  __shared__ double s_mean[GROUPS], s_rstd[GROUPS];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int cpg = C / GROUPS;
  if (threadIdx.x < GROUPS) {
    s_mean[threadIdx.x] = ws[(b * GROUPS + threadIdx.x) * 2];
    s_rstd[threadIdx.x] = ws[(b * GROUPS + threadIdx.x) * 2 + 1];
  }
  __syncthreads();

  const int columns = C / V;
  const int col = threadIdx.x % columns, lane = threadIdx.x / columns;
  float scale[V], shift[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = col * V + j, g = c / cpg;
    const double sc = (double)gamma[c] * s_rstd[g];
    scale[j] = (float)sc;
    shift[j] = (float)((double)beta[c] - s_mean[g] * sc);
  }
  const int r0 = tile * rows, r1 = min(r0 + rows, HW);
  const long long offset = (long long)b * HW * C + col * V;
  for (int r = r0 + lane; r < r1; r += lanes * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * lanes < r1) Vec<T>::load(x + offset + (long long)(r + u * lanes) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * lanes < r1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = fmaf(v[u][j], scale[j], shift[j]);
          v[u][j] = SILU ? t / (1.f + expf(-t)) : t;
        }
        Vec<T>::store(y + offset + (long long)(r + u * lanes) * C, v[u]);
      }
    }
  }
}

long long workspace_doubles(int B, int tiles) {
  return head_doubles(B) + 2LL * GROUPS * B * tiles;
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta, double* ws, int B,
           int HW, int C, float eps, bool silu, cudaStream_t stream) {
  const Plan p = make_plan(B, HW, C, sizeof(T));
  const dim3 grid(p.tiles, B);
  const size_t smem = 2ull * p.lanes * C * sizeof(double);  // at most 40 KB
  group_norm_nhwc_stats_kernel<T><<<grid, p.threads, smem, stream>>>(
      static_cast<const T*>(x), ws, HW, C, p.rows, p.lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_norm_nhwc_finalize_kernel<<<B, FINAL_THREADS, 0, stream>>>(ws, HW, C, p.tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    group_norm_nhwc_apply_kernel<T, true><<<grid, p.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), ws, gamma, beta, HW, C, p.rows, p.lanes);
  else
    group_norm_nhwc_apply_kernel<T, false><<<grid, p.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), ws, gamma, beta, HW, C, p.rows, p.lanes);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int HW, int C, int groups, int dtype) {
  return B < 1 || B > 65535 || HW < 1 || groups != GROUPS || C < GROUPS || C > MAX_C ||
         C % GROUPS || (dtype != 0 && dtype != 1);
}

int elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// Bytes of workspace a call needs (workspace_doubles); 0 for a shape the kernels
// do not take.
extern "C" long long minsdtf_group_norm_workspace_bytes(int B, int HW, int C, int dtype) {
  if (bad_shape(B, HW, C, GROUPS, dtype)) return 0;
  return 8 * workspace_doubles(B, make_plan(B, HW, C, elem_bytes(dtype)).tiles);
}

// GroupNorm (+ SiLU when silu != 0) of x, (B, H*W, C) in NHWC memory, into y of the
// same layout. dtype 0 = fp32, 1 = bf16; gamma and beta fp32 of C; workspace of
// minsdtf_group_norm_workspace_bytes bytes. x, y and the workspace 16-byte
// aligned. Returns a cudaError_t, 0 on success.
extern "C" int minsdtf_group_norm_nhwc(const void* x, void* y, const float* gamma,
                                       const float* beta, void* workspace, int B, int HW, int C,
                                       int groups, float eps, int silu, int dtype, void* stream) {
  if (bad_shape(B, HW, C, groups, dtype) || !(eps >= 0.f)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(workspace)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  double* ws = static_cast<double*>(workspace);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, gamma, beta, ws, B, HW, C, eps, silu != 0, s);
  return launch<float>(x, y, gamma, beta, ws, B, HW, C, eps, silu != 0, s);
}
