// Element types of the port's attention kernels (paged_attention.cu,
// mla_attention.cu, flash_attention.cu): q and the pool (or k/v) are each
// float or bf16, as in the TPU kernels, which upcast to f32, compute in f32
// and round once where they write.  A bf16 element becomes an f32 exactly
// (its 16 bits shifted up) where it is read; from_f32 / store4 round to
// nearest even where an output is written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace elem {

using bf16 = __nv_bfloat16;

// Element-type codes of the C entry points (kernels/paged_attention/
// paged_attention.py: DTYPE_CODES).
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// Four consecutive elements (4-element aligned) as floats; bf16 to f32 is
// exact (the 16 bits shifted up).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Elements of one cp.async chunk of a row of hd elements: 16 bytes, or 8
// for bf16 rows whose hd is not a multiple of 8 (hd a multiple of 4: such
// rows, and a fused pool's V half and odd heads, sit 8 bytes off 16).
template <typename T>
__host__ __device__ __forceinline__ int chunk_elems(int hd) {
  return sizeof(T) == 4 ? 4 : (hd % 8 == 0 ? 8 : 4);
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<TQ>{}, Type<TP>{}) for the element types the codes name, or
// cudaErrorInvalidValue for a code that names none: a buffer is never
// read as another type than its own.
template <typename F>
cudaError_t with_types(int q_dtype, int pool_dtype, F&& f) {
  if (q_dtype == DT_F32 && pool_dtype == DT_F32) return f(Type<float>{}, Type<float>{});
  if (q_dtype == DT_F32 && pool_dtype == DT_BF16) return f(Type<float>{}, Type<bf16>{});
  if (q_dtype == DT_BF16 && pool_dtype == DT_F32) return f(Type<bf16>{}, Type<float>{});
  if (q_dtype == DT_BF16 && pool_dtype == DT_BF16) return f(Type<bf16>{}, Type<bf16>{});
  return cudaErrorInvalidValue;
}

}  // namespace elem
