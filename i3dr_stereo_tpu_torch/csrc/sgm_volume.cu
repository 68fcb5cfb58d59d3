// sgm_volume — one SGM path direction over a (B, H, W, D) cost volume,
// folded into the running sum in place (sgm_volume.cuh has the kernel,
// what it replaces and its design). This file holds the entry point and
// the float32-out ops; sgm_volume_int.cu the int32-out ops, so the two
// halves of the instantiations compile side by side.
#include "sgm_volume.cuh"

namespace i3dr {

int volume_launch_f32(int op, const VolumeArgs& a, bool u8,
                      cudaStream_t stream) {
  switch (op) {
    case volume_op(false, ACC_NONE, false):
      return volume_launch_op<volume_op(false, ACC_NONE, false)>(a, u8,
                                                                 stream);
    case volume_op(true, ACC_NONE, false):
      return volume_launch_op<volume_op(true, ACC_NONE, false)>(a, u8,
                                                                stream);
    case volume_op(false, ACC_F32, false):
      return volume_launch_op<volume_op(false, ACC_F32, false)>(a, u8,
                                                                stream);
    case volume_op(true, ACC_F32, false):
      return volume_launch_op<volume_op(true, ACC_F32, false)>(a, u8,
                                                               stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace i3dr

// C: uint8 (u8 = 1, 255 = invalid) or float32 costs, D the volume's exact
// disparity count, 1 to 512. out: the plane written, float32 or (out_i32)
// int32. x: a float32 plane added to L first, or null. acc: a plane added
// last, or null; acc_kind 1 float32 (float32 out only), 2 int32 or 3 int16
// (int32 out only). x and acc may be out itself.
extern "C" int i3dr_sgm_volume(const void* C, int u8, void* out, int out_i32,
                               const void* x, const void* acc, int acc_kind,
                               int B, int H, int W, int D, int dy, int dx,
                               float p1, float p2, void* stream) {
  using namespace i3dr;
  if ((dy == 0 && dx == 0) || dy < -1 || dy > 1 || dx < -1 || dx > 1 ||
      lanes_k(D) == 0 || (acc == nullptr) != (acc_kind == ACC_NONE) ||
      acc_kind < ACC_NONE || acc_kind > ACC_I16 ||
      (acc_kind == ACC_F32 && out_i32) ||
      ((acc_kind == ACC_I32 || acc_kind == ACC_I16) && !out_i32))
    return (int)cudaErrorInvalidValue;
  VolumeArgs a;
  a.C = C, a.out = out, a.x = x, a.acc = acc;
  a.H = H, a.W = W, a.D = D, a.dy = dy, a.dx = dx;
  a.n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  a.n_warps = (long long)B * a.n_lines;
  a.p1 = p1, a.p2 = p2;
  if (a.n_warps == 0) return 0;
  const int op = volume_op(x != nullptr, acc_kind, out_i32 != 0);
  return out_i32 ? volume_launch_i32(op, a, u8 != 0, (cudaStream_t)stream)
                 : volume_launch_f32(op, a, u8 != 0, (cudaStream_t)stream);
}
