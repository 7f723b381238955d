// Device helpers shared by the row-summing kernels (segment_sum.cu,
// sorted_scatter.cu): one column group of an f32 row, a float or a
// float4 (16 B), zeroed and added lane by lane.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void add_to(float& a, float v) { a += v; }
__device__ __forceinline__ void add_to(float4& a, float4 v) {
  a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
}
template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
