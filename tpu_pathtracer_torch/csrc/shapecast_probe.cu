// The shape-cast probe's cases for NVIDIA Hopper (sm_90a): K26.
//
// Replaces the TPU kernels that experiments/shapecast_probe.py::main
// builds around each of its CASES: a kernel that applies one reshape,
// transpose, dot, min or iota move to an (8, 128) tile x and writes
// sum(r) of the result into every element of an (8, 128) tile. On a TPU
// the probe asks which moves Mosaic accepts; a CUDA kernel indexes memory
// freely, so the question has no counterpart here, and the kernel ports
// what the cases compute.
//
// Design. One block a case (block b runs case first + b), 1024 threads
// over the 1024 elements of x, staged in shared memory with its bf16
// rounding beside it. Each case is index arithmetic from an element e of
// its result r (row-major) to the x it reads: the reshapes, transposes,
// slices and broadcasts move no data. The two dot cases compute only the
// entries of the [:8, :128] slice that enters the sum, each a sequential
// sum over the contraction of bf16 products in float32 (a product of two
// bf16 values is exact in float32). The min and argmin cases keep the
// first of equal values; the iota case is the identity's slice.
//
// The sum has one fixed order: thread t adds the elements t, t + 1024,
// t + 2048, ... of r from 0, then the 1024 partial sums are halved
// pairwise (p[t] += p[t + h], h = 512, ..., 1). The plain PyTorch
// version (tpu_pathtracer_torch/experiments/shapecast_probe.py) sums in
// the same order, so the two are bit-equal (built with -fmad=false).
//
// What bounds it: 4 KB in and 4 KB a case out, and the dots' products
// (the A @ B^T case: 1024 x 1024 products and sums); a launch is a few
// microseconds of latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 1024;  // elements of x, threads a block
constexpr int kCases = 15;

// Elements of each case's r (row-major), in the TPU file's order.
__constant__ int c_size[kCases] = {1024, 1024, 1024, 1024, 1024, 1024, 8192,
                                   1024, 1024, 1024, 1024, 512,  1024, 1024,
                                   1024};

__device__ float elem(int c, int e, const float* xs, const float* xb) {
  switch (c) {
    case 0:   // reshape (8,128)->(1024,1), * 2
    case 1:   // reshape (8,128)->(1,1024), * 2
    case 3:   // row as a (1024,1) column, * 2
      return xs[e] * 2.f;
    case 2:   // (1,1024) * 1 -> (8,128)
    case 4:   // (1024,1) * 1 -> (8,128)
      return xs[e] * 1.f;
    case 5:   // x.T (128,8) * 2: r[a, b] = x[b, a]
      return xs[(e % 8) * 128 + e / 8] * 2.f;
    case 6:   // broadcast (64,1024) * 1, .T[:128] (128,64) * 2
      return (xs[e / 64] * 1.f) * 2.f;
    case 7: {  // (64,1024)^T (64,1024) over dim 0, [:8, :128]
      const float a = xb[e / 128], b = xb[e % 128];
      float acc = 0.f;
      for (int k = 0; k < 64; ++k) acc = acc + a * b;
      return acc;
    }
    case 8: {  // (256,1024) @ (256,1024)^T, [:8, :128]: every row is x
      float acc = 0.f;
      for (int k = 0; k < kN; ++k) acc = acc + xb[k] * xb[k];
      return acc;
    }
    case 9:   // (64,8,128) * 1 -> (64,1024), [:8, :128]
      return xs[e % 128] * 1.f;
    case 10:  // (768,1024) * 1 -> (6144,128), rows 24-31
      return xs[(24 * 128 + e) % kN] * 1.f;
    case 11:  // (1024,1) x (1,64) -> (1024,64), [:8, :128] = [:8, :64]
      return xs[e / 64] * xs[e % 64];
    case 12: {  // min over the 1024 rows of broadcast (1024,1024) * 1
      float m = xs[e] * 1.f;
      for (int k = 1; k < kN; ++k) {
        const float v = xs[e] * 1.f;
        m = v < m ? v : m;
      }
      return m;
    }
    case 13: {  // (1024,1) * ones (1,64): row min + first argmin
      float m = xs[e] * 1.f;
      int a = 0;
      for (int j = 1; j < 64; ++j) {
        const float v = xs[e] * 1.f;
        if (v < m) {
          m = v;
          a = j;
        }
      }
      return m + static_cast<float>(a);
    }
    default:  // 14: iota (1024,1024) i0 == i1 as bf16, [:8, :128]
      return e / 128 == e % 128 ? 1.f : 0.f;
  }
}

__global__ void __launch_bounds__(kN)
shapecast_kernel(const float* __restrict__ x, int first,
                 float* __restrict__ out) {
  __shared__ float xs[kN];
  __shared__ float xb[kN];
  __shared__ float part[kN];
  const int c = first + blockIdx.x;
  const int t = threadIdx.x;
  xs[t] = x[t];
  xb[t] = __bfloat162float(__float2bfloat16_rn(x[t]));
  __syncthreads();
  float acc = 0.f;
  for (int e = t; e < c_size[c]; e += kN) acc = acc + elem(c, e, xs, xb);
  part[t] = acc;
  for (int h = kN / 2; h > 0; h /= 2) {
    __syncthreads();
    if (t < h) part[t] = part[t] + part[t + h];
  }
  __syncthreads();
  out[blockIdx.x * kN + t] = part[0];
}

}  // namespace

// Runs cases first .. first + count - 1 on x [8, 128] (one block each)
// into out [count, 8, 128] on `stream`. Returns cudaGetLastError()
// (0 = launched).
extern "C" int shapecast_launch(const float* x, int first, int count,
                                float* out, void* stream) {
  if (first < 0 || count < 0 || first + count > kCases)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return static_cast<int>(cudaSuccess);
  shapecast_kernel<<<count, kN, 0, static_cast<cudaStream_t>(stream)>>>(
      x, first, out);
  return static_cast<int>(cudaGetLastError());
}
