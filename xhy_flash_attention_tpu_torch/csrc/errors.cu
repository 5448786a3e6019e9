// Error text for the codes the kernel entry points return.
#include "common.cuh"

XFA_EXPORT const char* xfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
