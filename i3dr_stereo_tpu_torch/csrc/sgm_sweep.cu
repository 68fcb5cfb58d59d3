// sgm_sweep — the sweeps of the flagship SGM stage that fold one
// direction's path costs into the running sum (sgm_sweep.cuh has the
// kernel, what it replaces and its design). The sweep that ends in the
// WTA is built from sgm_sweep_wta.cu, so the two compile side by side.
#include "sgm_sweep.cuh"

// op: a SweepOp below WTA_I16. C is uint8, or (wide = 1, STORE_I16 only)
// census_cost's int16 unclamped plane. S16 / F32: the running sums the op
// reads and writes in place (null where it uses none).
extern "C" int i3dr_sgm_sweep(const void* C, int wide, int op, void* S16,
                              void* F32, int B, int H, int W, int dy, int dx,
                              float p1, float p2, void* stream) {
  using namespace i3dr;
  if (wide && op != STORE_I16) return (int)cudaErrorInvalidValue;
#define I3DR_SWEEP_OP(T, OP)                                             \
  sweep_launch<T, OP>(C, S16, F32, nullptr, B, H, W, dy, dx, p1, p2, 0, \
                      0.0f, (cudaStream_t)stream)
  switch (op) {
    case STORE_I16:
      return wide ? I3DR_SWEEP_OP(int16_t, STORE_I16)
                  : I3DR_SWEEP_OP(uint8_t, STORE_I16);
    case ADDF_I16: return I3DR_SWEEP_OP(uint8_t, ADDF_I16);
    case ADDI_I16: return I3DR_SWEEP_OP(uint8_t, ADDI_I16);
    case STORE_F32: return I3DR_SWEEP_OP(uint8_t, STORE_F32);
    case ADD_F32: return I3DR_SWEEP_OP(uint8_t, ADD_F32);
    case FIN_F32: return I3DR_SWEEP_OP(uint8_t, FIN_F32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef I3DR_SWEEP_OP
}
