// Copy shapes for K12 (csrc/relayout.cu awsm_split_rows) on one CUDA card:
// an (8, 1920*1080) f32 table copied by cudaMemcpyAsync, by persistent
// grid-stride grids (4 or 8 blocks an SM, 1-8 16-byte vectors in flight a
// thread, load and store hints) and by one-shot grids (each block a
// contiguous run of vectors), each timed with one event pair around 30
// launches, best and mean of 5 runs. Prints ms and the copy's TB/s.
//
// Build and run (repo root, one card):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/bench_k12_copy scripts/bench_k12_copy.cu
//   build/bench_k12_copy

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

// LD 0: __ldg; 1: ld.global.nc.L1::no_allocate
template <int LD>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  if (LD == 0) return __ldg(p);
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// ST 0: a plain store; 1: __stcs (evict-first)
template <int ST>
__device__ __forceinline__ void st(uint4* p, uint4 v) {
  if (ST == 0) {
    *p = v;
  } else {
    __stcs(p, v);
  }
}

// persistent: thread i copies i, i + G, ..., U of them in flight
template <int LD, int ST, int U>
__global__ void __launch_bounds__(256)
stride_copy(const uint4* x, size_t nv, uint4* o) {
  const size_t step = (size_t)gridDim.x * 256;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < nv;
       i += U * step) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * step < nv) v[u] = ld<LD>(x + i + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * step < nv) st<ST>(o + i + u * step, v[u]);
    }
  }
}

// one-shot: block b copies vectors [b T V, (b + 1) T V), thread t the V
// vectors t + u T
template <int T, int V, int LD, int ST>
__global__ void __launch_bounds__(T)
flat_copy(const uint4* x, size_t nv, uint4* o) {
  const size_t i = (size_t)blockIdx.x * T * V + threadIdx.x;
  uint4 v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if (i + u * T < nv) v[u] = ld<LD>(x + i + u * T);
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if (i + u * T < nv) st<ST>(o + i + u * T, v[u]);
  }
}

int main() {
  const size_t n = 8ull * 1920 * 1080, nv = n / 4;
  uint4 *x, *o;
  cudaMalloc(&x, n * 4);
  cudaMalloc(&o, n * 4);
  cudaMemset(x, 1, n * 4);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto time = [&](const char* name, auto launch) {
    for (int w = 0; w < 3; ++w) launch();
    cudaDeviceSynchronize();
    float best = 1e9f, sum = 0.f;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(a);
      for (int k = 0; k < 30; ++k) launch();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, a, b);
      ms /= 30;
      best = ms < best ? ms : best;
      sum += ms;
    }
    printf("%-44s best %.4f mean %.4f ms  %.2f TB/s  cudaError %d\n", name,
           best, sum / 5, 2.0 * n * 4 / best / 1e9, (int)cudaGetLastError());
  };
  time("cudaMemcpyAsync", [&] {
    cudaMemcpyAsync(o, x, n * 4, cudaMemcpyDeviceToDevice);
  });
#define STRIDE(LD, ST, U, B)                                             \
  time("persistent ld" #LD " st" #ST " U" #U " " #B " blocks an SM",     \
       [&] { stride_copy<LD, ST, U><<<sms * B, 256>>>(x, nv, o); });
  STRIDE(0, 1, 4, 8) STRIDE(0, 0, 4, 8) STRIDE(1, 0, 4, 8)
  STRIDE(1, 1, 4, 8) STRIDE(0, 0, 8, 8) STRIDE(0, 0, 1, 8)
  STRIDE(0, 1, 4, 4) STRIDE(1, 0, 8, 4)
#define FLAT(T, V, LD, ST)                                               \
  time("one-shot T" #T " V" #V " ld" #LD " st" #ST, [&] {                \
    flat_copy<T, V, LD, ST>                                              \
        <<<(unsigned)((nv + T * V - 1) / (T * V)), T>>>(x, nv, o);       \
  });
  FLAT(256, 1, 0, 0) FLAT(256, 2, 0, 0) FLAT(256, 4, 0, 0)
  FLAT(256, 8, 0, 0) FLAT(512, 2, 0, 0) FLAT(256, 4, 1, 1)
  FLAT(256, 2, 1, 1) FLAT(256, 8, 1, 1)
  time("cudaMemcpyAsync", [&] {
    cudaMemcpyAsync(o, x, n * 4, cudaMemcpyDeviceToDevice);
  });
  return 0;
}
