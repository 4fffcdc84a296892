// Tensor maps for TMA tile loads (hopper.cuh tma_load_2d / tma_load_3d),
// built on the host per call from the operands' pointers. Used by
// vision_attention.cu and wq_wgmma.cuh.
//
// cuTensorMapEncodeTiled lives in libcuda; the runtime looks it up for us
// (by name, cudaGetDriverEntryPoint), so the library links no libcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>

typedef CUresult (*TmaEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline TmaEncodeTiled tma_encoder() {
  static TmaEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TmaEncodeTiled>(p);
  }
  return fn;
}

// A map of `rank` dimensions (dims innermost first; strides in bytes of
// dimensions 1 .. rank - 1) whose box is `box` elements, written into
// shared memory in `swizzle`; elements past the extent read as zeros.
// Returns a cudaError_t.
static inline int tma_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                          const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                          CUtensorMapSwizzle swizzle) {
  TmaEncodeTiled enc = tma_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, dtype, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box,
                         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A row-major matrix of `rows` rows of `cols` elements, `row_bytes` apart,
// as a 2-D map with a box of box_cols x box_rows.
static inline int tma_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
                             uint64_t cols, uint64_t rows, uint64_t row_bytes, uint32_t box_cols,
                             uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return tma_map(map, dtype, 2, ptr, dims, strides, box, swizzle);
}
