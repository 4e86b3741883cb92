// The reference's double -> short store on the card (counterpart of
// utils/cnum.py): MSVC/x86-64 lowers it as cvttsd2si into 32 bits (NaN or
// a value out of int32 range gives INT32_MIN) and keeps the low 16 bits.
// A GPU's own double -> int conversion saturates instead (INT32_MAX for a
// large value, 0 for NaN), so the range is checked first.  Shared by the
// GEQ, NLMS and BNLMS kernels.

#pragma once

#include <limits.h>
#include <stdint.h>

namespace {

// trunc(v) lies in [-2^31, 2^31 - 1] exactly when -2^31 - 1 < v < 2^31;
// NaN fails both comparisons.  Returns the short's value as an int.
__device__ __forceinline__ int c_short(double v) {
  const int i = (v > -2147483649.0 && v < 2147483648.0) ? __double2int_rz(v) : INT_MIN;
  return (int)(int16_t)(uint16_t)(i & 0xffff);
}

}  // namespace
