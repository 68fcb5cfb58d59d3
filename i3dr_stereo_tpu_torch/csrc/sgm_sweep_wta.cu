// sgm_sweep_wta — the last sweep of the flagship SGM stage: it adds its
// direction to the running sum in registers and does the WTA there, so
// the summed volume is never written (sgm_sweep.cuh has the kernel, what
// it replaces and its design).
#include "sgm_sweep.cuh"

// acc: the running sum, int16 (acc_f32 = 0; 4 paths) or float32
// (acc_f32 = 1; 8 paths), read only. disp: float32 (B, H, W) out.
extern "C" int i3dr_sgm_sweep_wta(const void* C, void* acc, int acc_f32,
                                  void* disp, int B, int H, int W, int dy,
                                  int dx, float p1, float p2, int subpixel,
                                  float ur, void* stream) {
  using namespace i3dr;
  return acc_f32 ? sweep_launch<uint8_t, WTA_F32>(C, nullptr, acc, disp, B, H,
                                                  W, dy, dx, p1, p2, subpixel,
                                                  ur, (cudaStream_t)stream)
                 : sweep_launch<uint8_t, WTA_I16>(C, acc, nullptr, disp, B, H,
                                                  W, dy, dx, p1, p2, subpixel,
                                                  ur, (cudaStream_t)stream);
}
