// Fused multi-step soil-column kernel for the implicit steppers (kernel mode
// B4) on the plain soil and under a MOST top, without the step policies (the
// plain soil's are implicit_policy_kernel.cu's, built behind the sources the
// first phases of chip_smoke.py launch).  The kernel, and what it replaces,
// is in implicit_column.cuh.

#include "implicit_column.cuh"

namespace {

// The stepper and branch bits select a template instance; MODE_PCR is read
// at run time.  BackwardEulerRichards needs dynamic water, and
// BackwardEulerSoil dynamic water and heat.  MODE_COLUMNS (per-column kinds
// and geometry) joins TR-BDF2 and BackwardEulerRichards on the coupled and
// water-only branches (implicit_columns_kernel.cu has the other modes with
// it); MODE_MOST each stepper on the coupled branch.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    case MODE_TRBDF2: return launch<T, MODE_TRBDF2>(args, block, stream);
    case MODE_TRBDF2 | MODE_WATER: return launch<T, MODE_TRBDF2 | MODE_WATER>(args, block, stream);
    case MODE_TRBDF2 | MODE_HEAT: return launch<T, MODE_TRBDF2 | MODE_HEAT>(args, block, stream);
    case MODE_BE_RICHARDS: return launch<T, MODE_BE_RICHARDS>(args, block, stream);
    case MODE_BE_RICHARDS | MODE_WATER:
      return launch<T, MODE_BE_RICHARDS | MODE_WATER>(args, block, stream);
    case MODE_BE_SOIL: return launch<T, MODE_BE_SOIL>(args, block, stream);
    case MODE_TRBDF2 | MODE_MOST: return launch<T, MODE_TRBDF2 | MODE_MOST>(args, block, stream);
    case MODE_BE_RICHARDS | MODE_MOST: return launch<T, MODE_BE_RICHARDS | MODE_MOST>(args, block, stream);
    case MODE_BE_SOIL | MODE_MOST: return launch<T, MODE_BE_SOIL | MODE_MOST>(args, block, stream);
    case MODE_TRBDF2 | MODE_COLUMNS: return launch<T, MODE_TRBDF2 | MODE_COLUMNS>(args, block, stream);
    case MODE_TRBDF2 | MODE_WATER | MODE_COLUMNS:
      return launch<T, MODE_TRBDF2 | MODE_WATER | MODE_COLUMNS>(args, block, stream);
    case MODE_BE_RICHARDS | MODE_COLUMNS:
      return launch<T, MODE_BE_RICHARDS | MODE_COLUMNS>(args, block, stream);
    case MODE_BE_RICHARDS | MODE_WATER | MODE_COLUMNS:
      return launch<T, MODE_BE_RICHARDS | MODE_WATER | MODE_COLUMNS>(args, block, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
