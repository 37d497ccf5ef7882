// K6's attributed mode (chunk_replay.cuh, ATTR = true; telemetry series and
// timeline on the plain path): its instantiation in a translation unit of its
// own, linked into chunk_replay.cu's library, whose entry ksim_chunk_replay
// checks the arguments and calls this launch when it is given counters.
#define KSIM_SECOND_TU  // chunk_replay.cu exports ksim_args_size
#include "chunk_replay.cuh"

// Write the counters into constant memory on `stream`, then launch the
// attributed kernel with the summary build's parameters `params`.
int ksim_chunk_replay_attributed_launch(void** params, int grid, int C, const KsimReject& rj,
                                        cudaStream_t stream) {
  cudaError_t e = cudaMemcpyToSymbolAsync(ksim_k6_reject, &rj, sizeof rj, 0,
                                          cudaMemcpyHostToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  return ksim_launch_clusters((const void*)ksim_chunk_replay_kernel<true, false>, grid,
                              K6_THREADS, C, params, stream);
}

cudaError_t ksim_chunk_replay_attributed_attrs(cudaFuncAttributes* at) {
  return cudaFuncGetAttributes(at, (const void*)ksim_chunk_replay_kernel<true, false>);
}
