// Greedy in-order NMS over a valid prefix, for Hopper (sm_90a).
//
// Replaces the TPU kernel birdsoundclassif_tpu/ops/pallas_nms.py:
// nms_in_order_pallas (body _make_kernel). Semantics are those of
// greedy_nms_in_order(valid_prefix=True) in both packages' ops/nms.py:
// boxes (B, N, 4) float32 arrive already in greedy order with the valid
// entries as a prefix of length n_valid[b]; for each i < n_valid still kept,
// clear keep[j] for every j > i with IoU(i, j) >= iou_thresh, where
// IoU = inter / (area_i + area_j - inter) with +1 widths and heights.
// Entries at or past n_valid are never kept. Output: keep (B, N) bool.
//
// What bounds it on this card: a serial dependency chain of n_valid steps
// (whether box i suppresses depends on every earlier decision), each step
// O(N) independent IoU compares. The bytes are tiny (17 bytes a box) and
// the arithmetic is a few hundred MFLOP at most, so neither the memory nor
// the FP32 rate binds: the latency of one step does.
//
// Design: one thread block per batch row, so rows run in parallel on
// separate SMs and no block waits on another. The row's boxes, their areas
// (computed once) and the keep flags live in shared memory (21 bytes a box:
// 172 KB at N = 8192, dynamic shared memory with the attribute raised), so
// a step touches no device memory. Each step is one strided pass of the
// block's threads over j in (i, n_valid) and one __syncthreads(); a step
// whose pivot is already suppressed is skipped by every thread alike, with
// no barrier. The block reads its own n_valid on the device: no host sync.
//
// Bit-exact keep masks: ties at the threshold flip boxes, so the IoU uses
// the reference's operation order with explicit round-to-nearest
// intrinsics (no FMA contraction; the build also passes --fmad=false),
// IEEE division, and a float32 compare against a float32 threshold. The
// keep decision uses no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__global__ void __launch_bounds__(kThreads)
nms_in_order_kernel(const float4* __restrict__ boxes,
                    const int* __restrict__ n_valid, int n, float iou_thresh,
                    bool* __restrict__ keep) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;
  float* sarea = reinterpret_cast<float*>(sbox + n);
  unsigned char* skeep = reinterpret_cast<unsigned char*>(sarea + n);

  const int b = blockIdx.x;
  const float4* row = boxes + static_cast<size_t>(b) * n;
  int nv = n_valid[b];
  nv = nv < 0 ? 0 : (nv > n ? n : nv);

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 bj = row[j];
    sbox[j] = bj;
    sarea[j] = area_plus1(bj);
    skeep[j] = j < nv;
  }
  __syncthreads();

  for (int i = 0; i < nv; ++i) {
    // Every write to skeep is followed by a barrier before the next read,
    // so all threads see the same flag and skip the step together.
    if (!skeep[i]) continue;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < nv; j += blockDim.x) {
      if (!skeep[j]) continue;
      const float4 bj = sbox[j];
      const float iw = fmaxf(
          __fadd_rn(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 1.0f), 0.0f);
      const float ih = fmaxf(
          __fadd_rn(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 1.0f), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(sarea[j], ai), inter));
      if (iou >= iou_thresh) skeep[j] = 0;
    }
    __syncthreads();
  }

  bool* out = keep + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[j] = skeep[j] != 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a row of n boxes.
size_t nms_in_order_smem_bytes(int n) {
  return static_cast<size_t>(n) * (sizeof(float4) + sizeof(float) + 1);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// boxes: (batch, n, 4) float32, contiguous; n_valid: (batch,) int32;
// keep: (batch, n) bool. All three are device pointers.
int nms_in_order_launch(const void* boxes, const void* n_valid, int batch, int n,
                        float iou_thresh, void* keep, void* stream) {
  const size_t smem = nms_in_order_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_in_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_in_order_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_valid), n,
      iou_thresh, static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
