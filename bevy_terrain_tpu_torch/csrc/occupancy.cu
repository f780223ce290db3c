// The occupancy query of the kernel library: for each kernel instance of
// mesh_fused.cu, attach_sample.cu and fetch_resample.cu, its registers and
// static shared memory (cudaFuncGetAttributes) and the blocks of NTHREADS
// threads one SM holds at its dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).

#include <cuda_runtime.h>

#include <cstring>

#include "tile_quad.cuh"

// Instance `index` (0, 1, ... across the three sources): its name into
// name[0 .. name_len), blocks per SM, registers per thread, static and
// dynamic shared memory and local (spill) bytes per thread. Returns 0,
// -1 past the last instance, or a cudaError_t.
extern "C" int kernel_occupancy(int index, char* name, int name_len, int* blocks_per_sm,
                                int* registers, int* static_smem, int* dynamic_smem,
                                int* local_bytes) {
  int (*const sources[])(const KernelInstance**) = {
      mesh_fused_instances, attach_sample_instances, fetch_resample_instances};
  for (auto source : sources) {
    const KernelInstance* table;
    const int n = source(&table);
    if (index >= n) {
      index -= n;
      continue;
    }
    const KernelInstance& k = table[index];
    std::strncpy(name, k.name, name_len - 1);
    name[name_len - 1] = '\0';
    cudaError_t err = cudaSuccess;
    if (k.dynamic_smem > 0)
      err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 k.dynamic_smem);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.fn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k.fn, NTHREADS,
                                                          k.dynamic_smem);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *static_smem = (int)attr.sharedSizeBytes;
    *dynamic_smem = k.dynamic_smem;
    *local_bytes = (int)attr.localSizeBytes;
    return 0;
  }
  return -1;
}
