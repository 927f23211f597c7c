// Non-causal attention kernels for Hopper (sm_90a): softmax(q k^T * scale) v.
//
// K1 minsdtf_flash_onepass replaces minsdtf_tpu/ops/flash_attention.py
//    _onepass_kernel: a plain softmax in the exp2 domain over the whole KV row,
//    with scale * log2(e) folded into q (rounded to the input type), p rounded to
//    the V type before the PV product, and sum(p) taken over those ROUNDED p from
//    a ones column appended to V.
//
//    bf16 (the main path; flash_bf16_kernel<D, EXP2_ROUNDED_SUM> for head widths
//    40, 80, 160):
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
//    fp32 (the fp32 pipelines and tools.golden --audit; flash_onepass_f32_kernel,
//    the fp32 body below with K1's convention): fp32 p is its own rounding, so one
//    online sweep computes K1's function up to fp32 rounding.
//
// K2 minsdtf_flash_online replaces minsdtf_tpu/ops/flash_attention.py _kernel:
//    blockwise online softmax over a sequential KV grid axis, in the natural-exp
//    domain. s = (q k^T) * scale in fp32 with q as it is (not pre-scaled, not
//    re-rounded); a running max m; p = exp(s - m) in fp32; l sums the fp32 p;
//    acc += p (rounded to the V type) v with fp32 accumulation; both are rescaled
//    by exp(m_prev - m_new); the output is acc / l in the input type.
//
//    bf16, path A (d <= 160; flash_bf16_kernel<D, EXP_FP32_SUM>, D = 40, 80, 160):
//    every self-attention past 4096 keys, first the 1024px UNet's 128x128 level
//    (2, 16384, 8, 40), 125 launches an image.
//    Bound at (2, 16384, 8, 40): 687.2 GFLOP, 0.6948 ms at the bf16 tensor-core
//    peak, but the 4.3e9 exponentials take 1.0271 ms on the special-function
//    units (16 per clock per SM, 132 SMs, 1.98 GHz). As for K1 at d=40, the
//    exponentials set the floor.
//    What the design does about it: it is K1's wgmma body (tiles of 128 q rows and
//    64 keys, the 2-stage cp.async ring, the ragged-tail mask, no limit on Sk)
//    with K2's softmax convention chosen at compile time. It differs from K1 in
//    four places, each at most one instruction per score:
//    - Q is loaded as it is, with no scale fold and no re-rounding.
//    - p = ex2(s c - m c) with c = scale * log2(e): one FFMA per score against a
//      per-row m c. The running max m is kept on the raw scores (the kernels take
//      scale > 0, so the max of s is the max of s * scale; the wrapper turns a
//      scale <= 0 into a positive one by negating or zeroing k, which leaves
//      every score as it was), and the rescale factor is ex2((m_old - m_new) c).
//    - l sums the unrounded fp32 p, one FADD per score in registers. It is reduced
//      over the 4 lanes of a row once, in the epilogue, and rescaled with O.
//    - P [V | 1] is kept and its ones column ignored, so that one body and one set
//      of wgmma wrappers serve both kernels. The 8 extra columns cost 4 registers,
//      and at d=40 a fifth more P V work: the products, 0.83 ms with that
//      padding, stay below the exponentials' floor.
//
//    bf16, path B (d = 512; flash_online_d512_kernel, and
//    flash_online_d512_merge_kernel when the KV range is cut): the VAE mid-block,
//    (1, 4096, 1, 512) once per 512px image and (1, 16384, 1, 512) at 1024px.
//    Bound at (1, 4096, 1, 512): 34.4 GFLOP, 0.0347 ms at the bf16 peak. Two facts
//    shape it: O over 64 rows x 512 in fp32 is 256 registers a thread for one
//    warpgroup, and S = 4096 with one head is only 64 wgmma m64 q tiles for 132 SMs.
//    What the design does about it: it splits the output width over blocks.
//    - One block per (batch*head, 128-row q tile, half of d, KV part), two
//      warpgroups of 64 rows each. A warpgroup holds O (64 x 256 fp32) in 128
//      accumulator registers a thread.
//    - S = Q K^T over the full d = 512 (32 k16 steps of wgmma m64n32k16). Q (128 x
//      512 bf16, 128 KB) stays in shared memory and is read as the A operand by
//      descriptor: K-major without swizzle, LBO 128 B, SBO 64 chunks x 128 B.
//    - K tiles (32 keys x 512) and V tiles (32 keys x this block's 256 columns)
//      arrive in a 2-stage cp.async ring in core-matrix order, as in K1: 128 KB +
//      2 x (32 KB + 16 KB) = 224 KB of shared memory, one block per SM.
//    - The K/V loads from L2 bound it: at 64 q rows a block, one warpgroup, the
//      kernel took 0.41 ms, and 0.13 ms with the loads left out (PERF.md). 128 rows
//      share each tile, which halves the bytes per score. Each block starts its
//      KV sweep at a tile of its own, so that the SMs do not all read one tile
//      at the same moment.
//    - With fewer (q tile, half) blocks than SMs (64 at S = 4096, one head), the KV
//      range is cut into parts (split_kv: 2 at S = 4096), each block writes its
//      part's O and (m, l) in fp32 to a workspace, and a merge kernel rescales
//      them to the common max and writes acc / l in bf16.
//    - Path A's K2 softmax on the S registers; p rounded to bf16 and packed into
//      the A registers of P V (wgmma m64n256k16, V N-major).
//    - Epilogue: O / l rounded to bf16, staged in Q's shared memory, written in
//      16-byte stores.
//    The price: S is computed twice per q tile, once per half, so the products
//    are 1.5x the attention's, 51.5 GFLOP with a least time of 0.0521 ms: at most
//    a share of 0.67 of the bound.
//
//    The wrapper sends bf16 only at d in {40, 80, 160, 512} with 16-byte aligned
//    pointers and strides that are multiples of 8 elements; it zero-pads other
//    widths.
//
//    fp32 (flash_online_f32_kernel, the fp32 body with K2's convention, at d <= 192;
//    flash_online_f32_wide_kernel at d = 512).
//
// The fp32 kernels (K1's and K2's). The products stay true fp32 FFMA on the CUDA
// cores: the JAX kernels run Precision.HIGHEST and the port holds fp32 to 2e-5,
// which TF32 (and 3xTF32's other products) would not give.
//    Bound at the fp32 512px shapes: (2, 4096, 8, 40) is 42.9 GFLOP, 0.6410 ms at
//    the 67 TFLOP/s FFMA peak (128 lanes per SM, 132 SMs, 1.98 GHz); its 2.7e8
//    exponentials take 64 us on the special-function units, a tenth of that, so
//    the FFMA pipe sets the floor, and every other instruction (shared-memory
//    loads, max, exp, shuffles) takes issue slots from it. (1, 4096, 1, 512) is
//    34.4 GFLOP, 0.5128 ms. Shared memory returns one 128-byte wavefront a clock
//    per SM where the FFMA pipe takes four warp instructions, so the FFMA peak
//    needs at least 4 FFMA for every shared-memory load.
//    What the design does about it (d <= 192; flash_{onepass,online}_f32_kernel<
//    F32<D, TM, TN>>, D = 40, 80, 160, 192): an SGEMM's register blocking.
//    - One block of 4 warps per (batch*head, 16 TM q rows), KV tiles of 8 TN keys;
//      lane = rg + 4 cg. The tiles were chosen by timing (PERF.md): TM = TN = 8
//      at d = 40 (255 registers, no spill); TM = TN = 4 at d = 80, where at
//      (2, 1024, 8, 80) 8 x 4 leaves 128 blocks for 132 SMs and 4 x 8 one block
//      an SM (120 KB of shared memory), both 1.7x slower; at d = 160 TM = 4, TN =
//      2, whose 86 KB of shared memory let two blocks share an SM (4 x 4 took
//      132 KB and ran 1.4x slower).
//      A lane owns TM q rows (rg) and TN keys of the KV tile (cg + 8j): its TM x
//      TN scores, their p, its rows' m and l, and TM x D/8 outputs stay in
//      registers for the whole sweep. Per 4 of d it loads TN 16-byte K chunks and
//      4 TM/4 16-byte Q chunks for 4 TM TN FFMA (d = 40, TM = TN = 8: 16 FFMA a
//      load); in P V, per key, TM/4 16-byte P loads and D/32 16-byte V loads (plus
//      one 4- or 8-byte one at d = 40, 80) for TM D/8 FFMA (d = 40: 10 a load).
//    - Q is loaded once, transposed to [d][row] (K1: times scale * log2(e) in
//      fp32), so that a lane's rows at one d are contiguous. K and V tiles arrive
//      by 16-byte cp.async in a 2-stage ring, tile j + 1 loading while tile j
//      computes, one __syncthreads per tile. K rows are D + 4 floats apart (an odd
//      number of 16-byte chunks), so the two keys a quarter-warp reads lie in other
//      banks; every other read is a broadcast or 128 contiguous bytes. The ragged
//      KV tail is zero-filled (src-size 0) and its scores masked to -inf; ragged q
//      rows are zero and not stored.
//    - The row max and sum reduce over the 8 lanes of a row group (__shfl_xor_sync
//      4, 8, 16), the sum once, in the epilogue. One online sweep: O and l are
//      rescaled only when some max of the warp grew (a warp vote).
//    - P reaches P V through a staging tile of the warp's own (keys x rows, a row
//      per key padded to 36 or 16 floats: conflict-free 16-byte stores), written
//      and read by that warp alone (__syncwarp); there is no S buffer.
//    - K1's convention: q pre-scaled, p = ex2(s - m). K2's: q as it is, the max
//      kept on the raw scores (the wrapper hands the kernels a scale > 0, as for
//      bf16), p = ex2(s c - m c), one FFMA, c = scale * log2(e). Both sum the fp32 p.
//    d = 512 (flash_online_f32_wide_kernel, the VAE mid-block): Q for 64
//    rows x 512 is 128 KB and a 32-key K or V tile 64 KB, so Q cannot share shared
//    memory with a K/V ring for enough rows to reuse each K row. Q stays in
//    registers instead:
//    - One block of 8 warps per (batch*head, 32 q rows); a warp owns 4 rows, a
//      lane the same 16 of the 512 columns (4 lane + 128 c) of their Q and of their
//      O, both in registers (64 + 64 floats).
//    - S: per key, 4 16-byte K loads for 64 FFMA of the lane's partial dot
//      products; every 8 keys the warp reduce-scatters its 32 partials (4 rows x 8
//      keys) by 5 butterfly shuffle steps, which leaves lane L the score of row
//      L / 8, key L % 8, in a register: no S buffer. The softmax runs there (the max
//      over the 8 lanes of a row), and P goes to a 16-key x 4-row staging tile of
//      the warp, read back as one 16-byte broadcast per key for P V.
//    - K and V tiles of 16 keys in a 2-stage cp.async ring, 128 KB.
//    - S is computed once per q tile: 128 blocks at S = 4096 with one head, one a
//      SM. Splitting the output width over two blocks as bf16 path B does (S
//      computed twice, 1.5x the products, twice the blocks) measured 1.48 ms
//      against this design's 0.94 ms at (1, 4096, 1, 512) (PERF.md).
//    All the fp32 kernels take D in {40, 80, 160} (K1) or {40, 80, 160, 192, 512}
//    (K2) with 16-byte aligned pointers and strides that are multiples of 4
//    elements; the wrapper zero-pads other widths.
//
// All kernels read strided (B, S, H, D) tensors whose D axis is contiguous and
// write the output the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Sk, D;
  // strides in elements of the B, S and H axes; the D axis has stride 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
  float scale;
  // K2 path B only: the KV range is cut into `splits` parts; with more than one,
  // each part's unnormalised O and its (m, l) go to `ws` and a merge kernel
  // writes the output (see split_kv).
  int splits;
  float* ws;
};

// ---- bf16: FlashAttention on wgmma, scores in registers (K1, and K2 path A) ----

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

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// d (m64 x 32, fp32) += A (m64 x k16) . B (k16 x 32), both bf16 in shared memory
// and K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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
  else if constexpr (N == 256) wgmma_n256<TRANS_B>(d, a, desc, scale_d);
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

// The two softmax conventions of the bf16 wgmma body.
enum Softmax : int {
  // K1: scale * log2(e) folded into q and rounded, p = exp2(s - m), the row sum
  // over the rounded p from the ones column of P [V | 1].
  EXP2_ROUNDED_SUM = 0,
  // K2: q as it is, p = exp(s * scale - m * scale) by ex2, the row sum over the
  // fp32 p in registers.
  EXP_FP32_SUM = 1,
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

// The softmax on wgmma accumulator fragments. A warp holds 16 rows of the m64
// tile: s[j] holds columns 8j + 2t, +1 (t = lane % 4) of rows g and g + 8 (g =
// lane / 4) in elements 0, 1 and 2, 3. m, l and the other per-row values are
// indexed by hh: 0 for row g, 1 for row g + 8.

// Scores of keys at or past Sk, in the tile that starts at key k0, to -inf.
template <int NS>
__device__ __forceinline__ void mask_tail(float (&s)[NS][4], int k0, int Sk, int lane) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + j * 8 + 2 * (lane & 3) + (e & 1) >= Sk) s[j][e] = -INFINITY;
    }
  }
}

// The running max of each row over this tile too, across the 4 lanes that share
// the row; returns whether it grew for one of this lane's rows.
template <int NS>
__device__ __forceinline__ bool row_max(const float (&s)[NS][4], const float (&m)[2],
                                        float (&m_new)[2]) {
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
  return grew;
}

// m = m_new, with O (and K2's row sum l) rescaled by the factor for the old max.
// c = scale * log2(e) converts K2's raw-score max to the log2 domain.
template <int MODE, int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], float (&m)[2], const float (&m_new)[2],
                                        float c, float (&l)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float alpha = 1.f;
    if (m_new[hh] != m[hh])
      alpha = MODE == EXP2_ROUNDED_SUM ? ex2(m[hh] - m_new[hh]) : ex2((m[hh] - m_new[hh]) * c);
    m[hh] = m_new[hh];
    if (MODE == EXP_FP32_SUM) l[hh] *= alpha;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * hh] *= alpha;
      o[n][2 * hh + 1] *= alpha;
    }
  }
}

// p against the running max m, rounded to bf16 and packed into the A fragments of
// P V: pa[kk] covers keys 16kk .. 16kk + 15, i.e. score tiles 2kk and 2kk + 1 (the
// accumulator layout of two n8 column blocks is the k16 A layout). K2 adds the
// fp32 p to this lane's part of the row sums l.
template <int MODE, int NS>
__device__ __forceinline__ void softmax_p(const float (&s)[NS][4], const float (&m)[2], float c,
                                          float (&l)[2], uint32_t (&pa)[NS / 2][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mc = m[hh] * c;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p0, p1;
      if constexpr (MODE == EXP2_ROUNDED_SUM) {
        p0 = ex2(s[j][2 * hh] - m[hh]);
        p1 = ex2(s[j][2 * hh + 1] - m[hh]);
      } else {
        p0 = ex2(fmaf(s[j][2 * hh], c, -mc));
        p1 = ex2(fmaf(s[j][2 * hh + 1], c, -mc));
        l[hh] += p0;
        l[hh] += p1;
      }
      pa[j / 2][(j & 1) * 2 + hh] = pack_bf16(p0, p1);
    }
  }
}

// A row's sum over the 4 lanes that hold its columns.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K1's bf16 kernel (MODE = EXP2_ROUNDED_SUM) and K2's path A (EXP_FP32_SUM).
template <int D, int MODE>
__global__ void __launch_bounds__(Tile<D>::NT, 1) flash_bf16_kernel(Params p) {
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

  // Q as wgmma A fragments; at d=40 the last k16 step's upper half is zero. K1
  // folds scale * log2(e) in and rounds to bf16; K2 takes q as it is.
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
    if constexpr (MODE == EXP2_ROUNDED_SUM) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qa[ks][i]));
          qa[ks][i] = pack_bf16(f.x * qscale, f.y * qscale);
        }
      }
    }
  }

  // Accumulator fragments: s[j] and o[n] hold columns 8j + 2t, +1 (8n + 2t, +1)
  // of rows g and g + 8 of the warp's 16 rows; o[NO] holds the row sum of the
  // rounded p in every column (K1's; K2 ignores it and sums the fp32 p in l).
  float s[NS][4], o[NO + 1][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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

    if (it * BK + BK > p.Sk) mask_tail(s, it * BK, p.Sk, lane);  // the ragged tail
    // Running row max; rescale only if some max of the warp grew.
    float m_new[2];
    if (__any_sync(0xffffffffu, row_max(s, m, m_new))) rescale<MODE>(o, m, m_new, qscale, l);
    uint32_t pa[BK / 16][4];
    softmax_p<MODE>(s, m, qscale, l, pa);

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
    const float sum = MODE == EXP2_ROUNDED_SUM ? o[NO][2 * hh] : quad_sum(l[hh]);
    bf16* srow = sQ + (wrow + hh * 8 + g) * STR + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(srow + n * 8) =
          pack_bf16(o[n][2 * hh] / sum, o[n][2 * hh + 1] / sum);
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

// ---- K2, bf16, path B (d = 512): one block of two warpgroups per (batch*head,
// 128-row q tile, half of d, KV part) ----

struct Wide {
  static constexpr int D = 512;
  static constexpr int DO = D / 2;                 // output columns per block
  static constexpr int WG = 2;                     // warpgroups per block
  static constexpr int NT = 128 * WG;              // threads per block
  static constexpr int BQ = 64 * WG;               // q rows: 64 per warpgroup
  static constexpr int BK = 32;                    // keys per KV tile
  static constexpr int STAGES = 2;
  static constexpr int CH = D / 8;                 // 16-byte chunks per Q or K row
  static constexpr int CHO = DO / 8;               // 16-byte chunks per V row half
  static constexpr int NS = BK / 8;                // score n8 tiles
  static constexpr int NO = DO / 8;                // output n8 tiles
  static constexpr int KSTEPS = D / 16;            // k16 steps of q k^T
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * DO * 2;
  static constexpr int OSTR = DO + 8;              // output staging row stride in elements
  static constexpr size_t SMEM = size_t(Q_BYTES) + size_t(STAGES) * (K_BYTES + V_BYTES);
  static_assert(BQ * OSTR * 2 <= Q_BYTES, "the output staging fits in Q's space");
};

// Rows [row0, row0 + R) of CH 16-byte chunks of one (b, h) slice into dst by
// cp.async, in core-matrix order (chunk c of row r at ((r / 8) * CH + c) * 128 +
// (r % 8) * 16), zero past S. Thread order is shared-memory order.
template <int R, int CH, int NT>
__device__ __forceinline__ void load_core_rows(uint32_t dst, const bf16* src, long long stride,
                                               int row0, int S) {
  static_assert(R % 8 == 0 && R * CH % NT == 0, "tiling");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int t = idx >> 3;
    const int r = (t / CH) * 8 + (idx & 7), c = t % CH;
    const bool valid = row0 + r < S;
    cp_async16(dst + idx * 16, valid ? src + (long long)(row0 + r) * stride + c * 8 : src, valid);
  }
}

__global__ void __launch_bounds__(Wide::NT, 1) flash_online_d512_kernel(Params p) {
  using W = Wide;
  constexpr int BK = W::BK, NS = W::NS, NO = W::NO, STAGES = W::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;                   // [BQ / 8][CH][8][16 bytes]; later the output
  unsigned char* sK = sQ + W::Q_BYTES;            // [STAGES][BK / 8][CH][8][16 bytes]
  unsigned char* sV = sK + STAGES * W::K_BYTES;   // [STAGES][BK / 8][CHO][8][16 bytes]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = blockIdx.x & 1;
  const int q0 = (blockIdx.x >> 1) * W::BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bf16* qg = reinterpret_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kg = reinterpret_cast<const bf16*>(p.k) + b * p.kb + h * p.kh;
  const bf16* vg = reinterpret_cast<const bf16*>(p.v) + b * p.vb + h * p.vh + half * W::DO;
  // This block's part of the KV tiles: [t0, t0 + ntiles). It starts at tile
  // t0 + rot and wraps around, rot differing between q tiles, so that the blocks
  // running at once read different K/V tiles: one tile read by every SM at the
  // same moment measured slower (PERF.md).
  const int per = ((p.Sk + BK - 1) / BK + p.splits - 1) / p.splits;
  const int t0 = blockIdx.z * per;
  const int ntiles = min(per, (p.Sk + BK - 1) / BK - t0);
  const int rot = (blockIdx.x >> 1) % ntiles;
  auto tile_of = [&](int it) { return t0 + (it + rot < ntiles ? it + rot : it + rot - ntiles); };
  auto load_kv = [&](int it) {
    const int key0 = tile_of(it) * BK;
    load_core_rows<BK, W::CH, W::NT>(smem_u32(sK + (it % STAGES) * W::K_BYTES), kg, p.ks, key0,
                                     p.Sk);
    load_core_rows<BK, W::CHO, W::NT>(smem_u32(sV + (it % STAGES) * W::V_BYTES), vg, p.vs, key0,
                                      p.Sk);
  };

  // Q and tile 0 form the first group; tiles 0 .. STAGES-2 are in flight before the loop.
  load_core_rows<W::BQ, W::CH, W::NT>(smem_u32(sQ), qg, p.qs, q0, p.Sq);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  const float c = p.scale * LOG2E;
  float s[NS][4], o[NO][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  auto& sf = reinterpret_cast<float(&)[BK / 2]>(s);
  auto& of = reinterpret_cast<float(&)[W::DO / 2]>(o);
  const uint32_t qs = smem_u32(sQ) + (warp / 4) * 64 * W::CH * 16;  // the warpgroup's 64 rows

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it has landed, and every warp is done with tile it - 1
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    const uint32_t kb = smem_u32(sK + (it % STAGES) * W::K_BYTES);
    const uint32_t vb = smem_u32(sV + (it % STAGES) * W::V_BYTES);

    // S = Q K^T over all of d, Q and K both K-major in shared memory: LBO steps to
    // the next 8 of d, SBO to the next 8 rows.
    pin(sf);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W::KSTEPS; ++ks)
      wgmma_ss_n32(sf, gmma_desc(qs + ks * 256, 128, W::CH * 128),
                   gmma_desc(kb + ks * 256, 128, W::CH * 128), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(sf);

    const int key0 = tile_of(it) * BK;
    if (key0 + BK > p.Sk) mask_tail(s, key0, p.Sk, lane);  // the ragged tail
    float m_new[2];
    if (__any_sync(0xffffffffu, row_max(s, m, m_new))) rescale<EXP_FP32_SUM>(o, m, m_new, c, l);
    uint32_t pa[BK / 16][4];
    softmax_p<EXP_FP32_SUM>(s, m, c, l, pa);

    // O += P V over this block's 256 columns; V is N-major: LBO steps to the next
    // 8 keys, SBO to the next 8 of d.
    pin(of);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<W::DO, 1>(of, pa[kk], gmma_desc(vb + kk * 2 * W::CHO * 128, W::CHO * 128, 128), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(of);
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t4 = lane & 3, wrow = warp * 16;
  if (p.splits > 1) {
    // This part's O (not normalised) and (m, l) of each row, in fp32, for the merge.
    const long long row0 = ((long long)blockIdx.z * p.B * p.H + blockIdx.y) * p.Sq + q0 + wrow;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float sum = quad_sum(l[hh]);
      const int r = hh * 8 + g;
      if (q0 + wrow + r < p.Sq) {
        float* orow = p.ws + (row0 + r) * W::D + half * W::DO + 2 * t4;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<float2*>(orow + n * 8) = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
        if (half == 0 && t4 == 0) {
          float* ml = p.ws + (long long)p.splits * p.B * p.H * p.Sq * W::D + (row0 + r) * 2;
          ml[0] = m[hh];
          ml[1] = sum;
        }
      }
    }
    return;
  }
  __syncthreads();  // every warp's products have read Q, whose space takes the output

  // Epilogue: O / l into rows of OSTR elements, then 16-byte stores of the warp's
  // 16 rows that lie inside the sequence.
  bf16* so = reinterpret_cast<bf16*>(sQ);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(l[hh]);
    bf16* srow = so + (wrow + hh * 8 + g) * W::OSTR + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(srow + n * 8) =
          pack_bf16(o[n][2 * hh] / sum, o[n][2 * hh + 1] / sum);
  }
  __syncwarp();
  bf16* og = reinterpret_cast<bf16*>(p.o) + b * p.ob + h * p.oh + half * W::DO;
#pragma unroll
  for (int i = 0; i < 16 * W::CHO / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / W::CHO, ch = idx % W::CHO;
    const int sq = q0 + wrow + r;
    if (sq < p.Sq)
      *reinterpret_cast<uint4*>(og + (long long)sq * p.os + ch * 8) =
          *reinterpret_cast<const uint4*>(so + (wrow + r) * W::OSTR + ch * 8);
  }
}

// Path B's merge of the KV parts: for each row, m = max of the parts' m, and the
// output is sum(O_s a_s) / sum(l_s a_s) with a_s = exp(m_s - m), in bf16. One
// thread per 8 columns of a row.
__global__ void __launch_bounds__(256) flash_online_d512_merge_kernel(Params p) {
  constexpr int D = Wide::D;
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * (D / 8)) return;
  const long long row = idx / (D / 8);
  const int col = int(idx % (D / 8)) * 8;
  const float* ml = p.ws + p.splits * rows * D;
  const float c = p.scale * LOG2E;
  float m = -INFINITY;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, ml[(s * rows + row) * 2]);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, sum = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float a = ex2((ml[(s * rows + row) * 2] - m) * c);
    sum += ml[(s * rows + row) * 2 + 1] * a;
    const float4* os = reinterpret_cast<const float4*>(p.ws + (s * rows + row) * D + col);
    const float4 x = os[0], y = os[1];
    acc[0] += x.x * a; acc[1] += x.y * a; acc[2] += x.z * a; acc[3] += x.w * a;
    acc[4] += y.x * a; acc[5] += y.y * a; acc[6] += y.z * a; acc[7] += y.w * a;
  }
  const int bh = int(row / p.Sq), sq = int(row % p.Sq);
  bf16* og = reinterpret_cast<bf16*>(p.o) + (bh / p.H) * p.ob + (bh % p.H) * p.oh +
             (long long)sq * p.os + col;
  *reinterpret_cast<uint4*>(og) = make_uint4(pack_bf16(acc[0] / sum, acc[1] / sum),
                                             pack_bf16(acc[2] / sum, acc[3] / sum),
                                             pack_bf16(acc[4] / sum, acc[5] / sum),
                                             pack_bf16(acc[6] / sum, acc[7] / sum));
}

// ---- fp32: register-blocked FFMA attention (K1; K2 at d <= 192) ----

// A lane's share of the fp32 body: lane = rg + 4 cg; rg (0..3) picks its TM q rows
// of the warp's 4 TM, cg (0..7) its keys cg + 8j (j < TN) of each KV tile and its
// D / 8 output columns: 4 at 32 c + 4 cg for each c < D / 32, then CR at
// 32 (D / 32) + CR cg.
template <int D_, int TM_, int TN_>
struct F32 {
  static constexpr int D = D_, TM = TM_, TN = TN_;
  static constexpr int NT = 128;                  // threads: 4 warps
  static constexpr int WR = 4 * TM;               // q rows per warp
  static constexpr int BQ = 4 * WR;               // q rows per block
  static constexpr int BK = 8 * TN;               // keys per KV tile
  static constexpr int STAGES = 2;
  static constexpr int CH = D / 4;                // 16-byte chunks per row
  static constexpr int C4 = D / 32;               // a lane's 16-byte output chunks
  static constexpr int CR = D % 32 / 8;           // and its columns after them
  static constexpr int TD = 4 * C4 + CR;          // = D / 8
  static constexpr int KS = D + 4;                // K row stride: an odd number of chunks
  // P row stride (a row per key, a column per q row of the warp): the 16-byte
  // stores of a quarter-warp (two cg, four rg) then fall in 8 distinct bank groups.
  static constexpr int PS = TM == 8 ? 36 : 16;
  static constexpr int Q_FLOATS = D * BQ;         // Q transposed: [D][BQ]
  static constexpr int K_FLOATS = BK * KS;
  static constexpr int V_FLOATS = BK * D;
  static constexpr int P_FLOATS = BK * PS;        // per warp
  static constexpr size_t SMEM =
      4 * (size_t(Q_FLOATS) + STAGES * (K_FLOATS + V_FLOATS) + 4 * P_FLOATS);
  static_assert(D % 8 == 0 && CR <= 2 && (TM == 4 || TM == 8), "tiling");
};

// The tiles each fp32 width is built with (PERF.md has the times of others).
using F32_40 = F32<40, 8, 8>;
using F32_80 = F32<80, 4, 4>;
using F32_160 = F32<160, 4, 2>;
using F32_192 = F32<192, 4, 4>;

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int MODE>
__device__ __forceinline__ void f32_body(const Params& p) {
  constexpr int D = T::D, TM = T::TM, TN = T::TN, BQ = T::BQ, BK = T::BK, KS = T::KS;
  constexpr int PS = T::PS, CH = T::CH, C4 = T::C4, CR = T::CR, NT = T::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [D][BQ]
  float* sK = sQ + T::Q_FLOATS;                      // [STAGES][BK][KS]
  float* sV = sK + T::STAGES * T::K_FLOATS;          // [STAGES][BK][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane & 3, cg = lane >> 2;
  float* sP = sV + T::STAGES * T::V_FLOATS + warp * T::P_FLOATS;  // [BK][PS], this warp's
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * BQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const int ntiles = (p.Sk + BK - 1) / BK;

  // Key r of a tile to row r of its stage, chunk by chunk; thread order is chunk
  // order, so a warp copies whole rows.
  auto load_kv = [&](int tile) {
    const uint32_t dk = smem_u32(sK + (tile % T::STAGES) * T::K_FLOATS);
    const uint32_t dv = smem_u32(sV + (tile % T::STAGES) * T::V_FLOATS);
    const int key0 = tile * BK;
#pragma unroll
    for (int i = 0; i < (BK * CH + NT - 1) / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (BK * CH % NT == 0 || idx < BK * CH) {
        const int r = idx / CH, c = idx - (idx / CH) * CH;
        const bool valid = key0 + r < p.Sk;
        const long long key = valid ? key0 + r : 0;
        cp_async16(dk + (r * KS + c * 4) * 4, kg + key * p.ks + c * 4, valid);
        cp_async16(dv + (r * D + c * 4) * 4, vg + key * p.vs + c * 4, valid);
      }
    }
  };
  load_kv(0);
  cp_async_commit();

  // Q transposed, zero past Sq; K1 folds scale * log2(e) in.
  const float qmul = MODE == EXP2_ROUNDED_SUM ? p.scale * LOG2E : 1.f;
  for (int idx = threadIdx.x; idx < BQ * CH; idx += NT) {
    const int r = idx % BQ, c = idx / BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq)
      x = *reinterpret_cast<const float4*>(qg + (long long)(q0 + r) * p.qs + c * 4);
    sQ[(c * 4 + 0) * BQ + r] = x.x * qmul;
    sQ[(c * 4 + 1) * BQ + r] = x.y * qmul;
    sQ[(c * 4 + 2) * BQ + r] = x.z * qmul;
    sQ[(c * 4 + 3) * BQ + r] = x.w * qmul;
  }

  const float c = p.scale * LOG2E;
  const float* qw = sQ + warp * T::WR + rg * TM;  // this lane's rows at d = 0
  float o[TM][T::TD], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < T::TD; ++n) o[i][n] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed; every warp is done with tile it - 1
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    const float* kt = sK + (it % T::STAGES) * T::K_FLOATS + cg * KS;
    const float* vt = sV + (it % T::STAGES) * T::V_FLOATS;

    // S = Q K^T: per 4 of d, TN K chunks and 4 x TM/4 Q chunks for 4 TM TN FFMA.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < CH; ++d4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kt + j * 8 * KS + d4 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qf[TM];
#pragma unroll
        for (int hq = 0; hq < TM / 4; ++hq) {
          const float4 x = *reinterpret_cast<const float4*>(qw + (d4 * 4 + e) * BQ + hq * 4);
          qf[4 * hq] = x.x;
          qf[4 * hq + 1] = x.y;
          qf[4 * hq + 2] = x.z;
          qf[4 * hq + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qf[i], lane_of(kf[j], e), s[i][j]);
      }
    }

    if (it * BK + BK > p.Sk) {  // the ragged tail
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (it * BK + cg + 8 * j >= p.Sk)
#pragma unroll
          for (int i = 0; i < TM; ++i) s[i][j] = -INFINITY;
    }
    // The running max of each row over the 8 lanes of its row group; O and l are
    // rescaled only if some max of the warp grew.
    float m_new[TM];
    bool grew = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float x = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) x = fmaxf(x, s[i][j]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
      m_new[i] = fmaxf(m[i], x);
      grew |= m_new[i] != m[i];
    }
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float alpha = MODE == EXP2_ROUNDED_SUM ? ex2(m[i] - m_new[i])
                                                     : ex2((m[i] - m_new[i]) * c);
        m[i] = m_new[i];
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < T::TD; ++n) o[i][n] *= alpha;
      }
    }
    // p in place of s, summed into this lane's part of l, then staged for P V.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float mc = m[i] * c;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = MODE == EXP2_ROUNDED_SUM ? ex2(s[i][j] - m[i]) : ex2(fmaf(s[i][j], c, -mc));
        l[i] += s[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int hq = 0; hq < TM / 4; ++hq)
        *reinterpret_cast<float4*>(sP + (cg + 8 * j) * PS + rg * TM + hq * 4) =
            make_float4(s[4 * hq][j], s[4 * hq + 1][j], s[4 * hq + 2][j], s[4 * hq + 3][j]);
    __syncwarp();

    // O += P V: per key, TM/4 P chunks (broadcast) and the lane's V columns.
    const float* pw = sP + rg * TM;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float pf[TM];
#pragma unroll
      for (int hq = 0; hq < TM / 4; ++hq) {
        const float4 x = *reinterpret_cast<const float4*>(pw + k * PS + hq * 4);
        pf[4 * hq] = x.x;
        pf[4 * hq + 1] = x.y;
        pf[4 * hq + 2] = x.z;
        pf[4 * hq + 3] = x.w;
      }
      const float* vr = vt + k * D;
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 32 * c4 + 4 * cg);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          o[i][4 * c4] = fmaf(pf[i], x.x, o[i][4 * c4]);
          o[i][4 * c4 + 1] = fmaf(pf[i], x.y, o[i][4 * c4 + 1]);
          o[i][4 * c4 + 2] = fmaf(pf[i], x.z, o[i][4 * c4 + 2]);
          o[i][4 * c4 + 3] = fmaf(pf[i], x.w, o[i][4 * c4 + 3]);
        }
      }
      if constexpr (CR == 1) {
        const float x = vr[32 * C4 + cg];
#pragma unroll
        for (int i = 0; i < TM; ++i) o[i][4 * C4] = fmaf(pf[i], x, o[i][4 * C4]);
      } else if constexpr (CR == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vr + 32 * C4 + 2 * cg);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          o[i][4 * C4] = fmaf(pf[i], x.x, o[i][4 * C4]);
          o[i][4 * C4 + 1] = fmaf(pf[i], x.y, o[i][4 * C4 + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // O / l, l summed over the row group's 8 lanes; rows past Sq are not stored.
  float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    const int row = q0 + warp * T::WR + rg * TM + i;
    if (row >= p.Sq) continue;
    float* orow = og + (long long)row * p.os;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4)
      *reinterpret_cast<float4*>(orow + 32 * c4 + 4 * cg) =
          make_float4(o[i][4 * c4] / sum, o[i][4 * c4 + 1] / sum, o[i][4 * c4 + 2] / sum,
                      o[i][4 * c4 + 3] / sum);
    if constexpr (CR == 1) orow[32 * C4 + cg] = o[i][4 * C4] / sum;
    if constexpr (CR == 2)
      *reinterpret_cast<float2*>(orow + 32 * C4 + 2 * cg) =
          make_float2(o[i][4 * C4] / sum, o[i][4 * C4 + 1] / sum);
  }
}

// K1 in fp32, and K2 in fp32 at d <= 192: one body, two softmax conventions.
template <typename T>
__global__ void __launch_bounds__(T::NT) flash_onepass_f32_kernel(Params p) {
  f32_body<T, EXP2_ROUNDED_SUM>(p);
}

template <typename T>
__global__ void __launch_bounds__(T::NT) flash_online_f32_kernel(Params p) {
  f32_body<T, EXP_FP32_SUM>(p);
}

// ---- K2, fp32, d = 512: Q and O in registers, S by shuffles ----

struct WideF32 {
  static constexpr int D = 512;
  static constexpr int NT = 256, NW = NT / 32;
  static constexpr int R = 4;                  // q rows per warp
  static constexpr int BQ = NW * R;            // q rows per block
  static constexpr int BK = 16;                // keys per KV tile, two groups of 8
  static constexpr int STAGES = 2;
  static constexpr int QC = D / 128;           // a lane's 16-byte Q and O chunks: 4 lane + 128 c
  static constexpr int KV_FLOATS = BK * D;     // a K or V tile
  static constexpr int P_FLOATS = BK * R;      // per warp: [BK][R]
  static constexpr size_t SMEM = 4 * (size_t(STAGES) * 2 * KV_FLOATS + NW * P_FLOATS);
};

// One butterfly step of a reduce-scatter over the warp: this lane keeps the upper
// half of v[0, N) when `up`, adds the partner's copy of that half (lane ^ off).
template <int N>
__device__ __forceinline__ void scatter_step(float (&v)[32], bool up, int off) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The sum over the warp's 32 lanes of element `lane` of their v.
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  scatter_step<32>(v, lane & 16, 16);
  scatter_step<16>(v, lane & 8, 8);
  scatter_step<8>(v, lane & 4, 4);
  scatter_step<4>(v, lane & 2, 2);
  scatter_step<2>(v, lane & 1, 1);
  return v[0];
}

__global__ void __launch_bounds__(WideF32::NT, 1) flash_online_f32_wide_kernel(Params p) {
  using W = WideF32;
  constexpr int D = W::D, R = W::R, BK = W::BK, QC = W::QC, NT = W::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // [STAGES][BK][D]
  float* sV = sK + W::STAGES * W::KV_FLOATS;         // [STAGES][BK][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sP = sV + W::STAGES * W::KV_FLOATS + warp * W::P_FLOATS;  // [BK][R], this warp's
  const int row0 = blockIdx.x * W::BQ + warp * R;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const int ntiles = (p.Sk + BK - 1) / BK;

  auto load_kv = [&](int tile) {
    const uint32_t dk = smem_u32(sK + (tile % W::STAGES) * W::KV_FLOATS);
    const uint32_t dv = smem_u32(sV + (tile % W::STAGES) * W::KV_FLOATS);
    const int key0 = tile * BK;
#pragma unroll
    for (int i = 0; i < BK * D / 4 / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int r = idx / (D / 4), cc = idx % (D / 4);
      const bool valid = key0 + r < p.Sk;
      const long long key = valid ? key0 + r : 0;
      cp_async16(dk + idx * 16, kg + key * p.ks + cc * 4, valid);
      cp_async16(dv + idx * 16, vg + key * p.vs + cc * 4, valid);
    }
  };
  load_kv(0);
  cp_async_commit();

  // This warp's 4 q rows, the lane's 16 columns of each, zero past Sq.
  float4 q[R][QC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < QC; ++cc)
      q[r][cc] = row0 + r < p.Sq
                     ? *reinterpret_cast<const float4*>(qg + (long long)(row0 + r) * p.qs +
                                                        4 * lane + 128 * cc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);

  const float c = p.scale * LOG2E;
  float4 o[R][QC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < QC; ++cc) o[r][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  // The running max of row lane / 8, whose scores lanes 8 (lane / 8) .. + 7 hold,
  // and this lane's part of its sum.
  float m = -INFINITY, l = 0.f;
  const int my_row = lane >> 3, my_key = lane & 7;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    const float* kt = sK + (it % W::STAGES) * W::KV_FLOATS + 4 * lane;
    const float* vt = sV + (it % W::STAGES) * W::KV_FLOATS + 4 * lane;

    // S over all of d, 8 keys at a time: the lane's partial dot products of its 4
    // rows with each key over its 16 columns, reduce-scattered over the warp.
    float s[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float v[32];  // v[8 r + j]: row r, key 8 g + j
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float4 kf[QC];
#pragma unroll
        for (int cc = 0; cc < QC; ++cc)
          kf[cc] = *reinterpret_cast<const float4*>(kt + (8 * g + j) * D + 128 * cc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int cc = 0; cc < QC; ++cc) {
            acc = fmaf(q[r][cc].x, kf[cc].x, acc);
            acc = fmaf(q[r][cc].y, kf[cc].y, acc);
            acc = fmaf(q[r][cc].z, kf[cc].z, acc);
            acc = fmaf(q[r][cc].w, kf[cc].w, acc);
          }
          v[8 * r + j] = acc;
        }
      }
      s[g] = reduce_scatter(v, lane);  // row lane / 8, key 8 g + lane % 8
      if (it * BK + 8 * g + my_key >= p.Sk) s[g] = -INFINITY;  // the ragged tail
    }

    float x = fmaxf(s[0], s[1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
    const float m_new = fmaxf(m, x);
    if (__any_sync(0xffffffffu, m_new != m)) {
      const float alpha = ex2((m - m_new) * c);  // 1 where the max held, 0 at the first tile
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = __shfl_sync(0xffffffffu, alpha, 8 * r);
#pragma unroll
        for (int cc = 0; cc < QC; ++cc) {
          o[r][cc].x *= a;
          o[r][cc].y *= a;
          o[r][cc].z *= a;
          o[r][cc].w *= a;
        }
      }
    }
    const float mc = m * c;
    const float p0 = ex2(fmaf(s[0], c, -mc)), p1 = ex2(fmaf(s[1], c, -mc));
    l += p0 + p1;
    sP[my_key * R + my_row] = p0;
    sP[(8 + my_key) * R + my_row] = p1;
    __syncwarp();

    // O += P V: per key, one P chunk (the warp's 4 rows, a broadcast) and the
    // lane's V chunks.
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 pf = *reinterpret_cast<const float4*>(sP + k * R);
      const float pr[R] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
      for (int cc = 0; cc < QC; ++cc) {
        const float4 x4 = *reinterpret_cast<const float4*>(vt + k * D + 128 * cc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          o[r][cc].x = fmaf(pr[r], x4.x, o[r][cc].x);
          o[r][cc].y = fmaf(pr[r], x4.y, o[r][cc].y);
          o[r][cc].z = fmaf(pr[r], x4.z, o[r][cc].z);
          o[r][cc].w = fmaf(pr[r], x4.w, o[r][cc].w);
        }
      }
    }
  }
  cp_async_wait<0>();

  // O / l: l summed over the 8 lanes of each row, then handed to every lane.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh + 4 * lane;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sum = __shfl_sync(0xffffffffu, l, 8 * r);
    if (row0 + r >= p.Sq) continue;
#pragma unroll
    for (int cc = 0; cc < QC; ++cc)
      *reinterpret_cast<float4*>(og + (long long)(row0 + r) * p.os + 128 * cc) =
          make_float4(o[r][cc].x / sum, o[r][cc].y / sum, o[r][cc].z / sum, o[r][cc].w / sum);
  }
}

// The number of KV parts of a path-B call: with fewer (q tile, half) blocks than
// the card has SMs (at S = 4096 and one head, 64 blocks for 132 SMs), the KV
// range is cut into as many parts as keep the blocks within one wave, each part
// having at least one tile; else 1.
int split_kv(int B, int H, int Sq, int Sk) {
  static const int sms = [] {  // the port runs on one card: the current device at first use
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  const long long blocks = 2LL * ((Sq + Wide::BQ - 1) / Wide::BQ) * B * H;
  const int ntiles = (Sk + Wide::BK - 1) / Wide::BK;
  int splits = (int)std::min<long long>(std::max<long long>(1, sms / blocks), ntiles);
  const int per = (ntiles + splits - 1) / splits;
  return (ntiles + per - 1) / per;  // no part left empty
}

// A kernel's dynamic shared memory limit, set once per kernel (a function-local
// static at each call site), so no later launch, and no CUDA graph capture, makes
// the call. The port runs on one card: the attribute is set on the device current
// at the first call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int MODE>
cudaError_t allow_smem_bf16() {
  static const cudaError_t err = allow_smem(flash_bf16_kernel<D, MODE>, Tile<D>::SMEM);
  return err;
}

cudaError_t allow_smem_d512() {
  static const cudaError_t err = allow_smem(flash_online_d512_kernel, Wide::SMEM);
  return err;
}

template <int D, int MODE>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t err = allow_smem_bf16<D, MODE>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + T::BQ - 1) / T::BQ, p.B * p.H);
  flash_bf16_kernel<D, MODE><<<grid, T::NT, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_d512(const Params& p, cudaStream_t stream) {
  const cudaError_t err = allow_smem_d512();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(2 * ((p.Sq + Wide::BQ - 1) / Wide::BQ), p.B * p.H, p.splits);
  flash_online_d512_kernel<<<grid, Wide::NT, Wide::SMEM, stream>>>(p);
  if (p.splits == 1) return (int)cudaGetLastError();
  const long long threads = (long long)p.B * p.H * p.Sq * (Wide::D / 8);
  flash_online_d512_merge_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The kernels' cp.async and 16-byte loads and stores need 16-byte aligned rows:
// aligned pointers, and strides that are multiples of `per16` elements.
bool aligned16(const Params& p, const long long* st, int per16) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % per16) return false;
  return true;
}

template <typename K>
int blocks_per_sm(cudaError_t allowed, K kernel, int threads, size_t smem) {
  int n = 0;
  if (allowed != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

template <int D, int MODE>
int blocks_per_sm_bf16() {
  return blocks_per_sm(allow_smem_bf16<D, MODE>(), flash_bf16_kernel<D, MODE>, Tile<D>::NT,
                       Tile<D>::SMEM);
}

// K1 (MODE = EXP2_ROUNDED_SUM) or K2 (EXP_FP32_SUM) in fp32 at the width of T.
template <typename T, int MODE>
int launch_f32(const Params& p, cudaStream_t stream) {
  void (*kern)(Params) =
      MODE == EXP2_ROUNDED_SUM ? flash_onepass_f32_kernel<T> : flash_online_f32_kernel<T>;
  static const cudaError_t err = allow_smem(kern, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + T::BQ - 1) / T::BQ, p.B * p.H);
  kern<<<grid, T::NT, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_f32_wide(const Params& p, cudaStream_t stream) {
  static const cudaError_t err = allow_smem(flash_online_f32_wide_kernel, WideF32::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + WideF32::BQ - 1) / WideF32::BQ, p.B * p.H);
  flash_online_f32_wide_kernel<<<grid, WideF32::NT, WideF32::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// K1 and K2 in fp32 at the widths they are built for.
template <int MODE>
int launch_f32_width(const Params& p, cudaStream_t stream) {
  if (p.D == 40) return launch_f32<F32_40, MODE>(p, stream);
  if (p.D == 80) return launch_f32<F32_80, MODE>(p, stream);
  if (p.D == 160) return launch_f32<F32_160, MODE>(p, stream);
  if constexpr (MODE == EXP_FP32_SUM) {
    if (p.D == 192) return launch_f32<F32_192, MODE>(p, stream);
    if (p.D == 512) return launch_f32_wide(p, stream);
  }
  return (int)cudaErrorInvalidValue;
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
  p.qb = st[0]; p.qs = st[1]; p.qh = st[2];
  p.kb = st[3]; p.ks = st[4]; p.kh = st[5];
  p.vb = st[6]; p.vs = st[7]; p.vh = st[8];
  p.ob = st[9]; p.os = st[10]; p.oh = st[11];
  p.scale = scale;
  p.splits = 1;
  p.ws = nullptr;
  return p;
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int max_d) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > max_d || B * H > 65535;
}

}  // namespace

// q, k, v, o: (B, S, H, D) device tensors with the strides in `strides` (12 int64:
// B, S, H strides of q, k, v, o); dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t; 0 means the launch was accepted. K1 takes D in {40, 80, 160} with
// 16-byte aligned pointers and strides that are multiples of 16 bytes.
extern "C" int minsdtf_flash_onepass(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int Sq, int Sk, int D,
                                     const long long* strides, float scale, int dtype,
                                     void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, 160) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, H, Sq, Sk, D, strides, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!aligned16(p, strides, dtype == 1 ? 8 : 4)) return (int)cudaErrorMisalignedAddress;
  if (dtype == 0) return launch_f32_width<EXP2_ROUNDED_SUM>(p, s);
  if (D == 40) return launch_bf16<40, EXP2_ROUNDED_SUM>(p, s);
  if (D == 80) return launch_bf16<80, EXP2_ROUNDED_SUM>(p, s);
  if (D == 160) return launch_bf16<160, EXP2_ROUNDED_SUM>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of K1's bf16 kernel at head width D (40, 80 or 160) that one SM holds at
// once, by the CUDA occupancy calculator; 0 on an error.
extern "C" int minsdtf_onepass_bf16_blocks_per_sm(int D) {
  if (D == 40) return blocks_per_sm_bf16<40, EXP2_ROUNDED_SUM>();
  if (D == 80) return blocks_per_sm_bf16<80, EXP2_ROUNDED_SUM>();
  if (D == 160) return blocks_per_sm_bf16<160, EXP2_ROUNDED_SUM>();
  return 0;
}

// Bytes of fp32 workspace that minsdtf_flash_online needs for these shapes: a bf16
// call at D = 512 whose KV range is cut into parts (split_kv); 0 otherwise.
extern "C" long long minsdtf_online_workspace_bytes(int B, int H, int Sq, int Sk, int D,
                                                    int dtype) {
  if (dtype != 1 || D != 512 || bad_shape(B, H, Sq, Sk, D, 512)) return 0;
  const int splits = split_kv(B, H, Sq, Sk);
  return splits > 1 ? 4LL * splits * B * H * Sq * (D + 2) : 0;
}

// The same arguments as minsdtf_flash_onepass, and `workspace`: device memory of
// minsdtf_online_workspace_bytes bytes (nullptr when that is 0). K2 takes D in
// {40, 80, 160, 512} in bf16 (path A, then path B) and {40, 80, 160, 192, 512} in
// fp32, with 16-byte aligned pointers, strides that are multiples of 16 bytes and
// scale > 0.
extern "C" int minsdtf_flash_online(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int D,
                                    const long long* strides, float scale, int dtype,
                                    void* stream, void* workspace) {
  if (bad_shape(B, H, Sq, Sk, D, 512) || (dtype != 0 && dtype != 1) || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, B, H, Sq, Sk, D, strides, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!aligned16(p, strides, dtype == 1 ? 8 : 4)) return (int)cudaErrorMisalignedAddress;
  if (dtype == 0) return launch_f32_width<EXP_FP32_SUM>(p, s);
  if (D == 40) return launch_bf16<40, EXP_FP32_SUM>(p, s);
  if (D == 80) return launch_bf16<80, EXP_FP32_SUM>(p, s);
  if (D == 160) return launch_bf16<160, EXP_FP32_SUM>(p, s);
  if (D == 512) {
    p.splits = split_kv(B, H, Sq, Sk);
    p.ws = static_cast<float*>(workspace);
    if (p.splits > 1 && (p.ws == nullptr || reinterpret_cast<uintptr_t>(p.ws) % 16))
      return (int)cudaErrorInvalidValue;
    return launch_d512(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of K2's bf16 kernel at head width D (40, 80, 160: path A; 512: path B)
// that one SM holds at once, by the CUDA occupancy calculator; 0 on an error.
extern "C" int minsdtf_online_bf16_blocks_per_sm(int D) {
  if (D == 40) return blocks_per_sm_bf16<40, EXP_FP32_SUM>();
  if (D == 80) return blocks_per_sm_bf16<80, EXP_FP32_SUM>();
  if (D == 160) return blocks_per_sm_bf16<160, EXP_FP32_SUM>();
  if (D == 512)
    return blocks_per_sm(allow_smem_d512(), flash_online_d512_kernel, Wide::NT, Wide::SMEM);
  return 0;
}
