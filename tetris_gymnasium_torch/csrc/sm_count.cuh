// The card's streaming multiprocessors, read once (1 where they cannot be
// read): the launchers that size their blocks by the batch give every SM a
// block where a batch is small.  Host code, shared by the kernels' sources.
#pragma once

#include <cuda_runtime.h>

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 1;
  }
  return sms;
}
