// sgm_volume — the int32-out ops of the int16 mode (sgm_volume.cuh has
// the kernel; sgm_volume.cu the entry point and the float32-out ops).
#include "sgm_volume.cuh"

namespace i3dr {

int volume_launch_i32(int op, const VolumeArgs& a, bool u8,
                      cudaStream_t stream) {
  switch (op) {
    case volume_op(false, ACC_NONE, true):
      return volume_launch_op<volume_op(false, ACC_NONE, true)>(a, u8,
                                                                stream);
    case volume_op(true, ACC_NONE, true):
      return volume_launch_op<volume_op(true, ACC_NONE, true)>(a, u8,
                                                               stream);
    case volume_op(false, ACC_I32, true):
      return volume_launch_op<volume_op(false, ACC_I32, true)>(a, u8,
                                                               stream);
    case volume_op(true, ACC_I32, true):
      return volume_launch_op<volume_op(true, ACC_I32, true)>(a, u8,
                                                              stream);
    // int16 acc: the lean path's forward plane, uint8 costs only
    case volume_op(false, ACC_I16, true):
      return u8 ? volume_launch_k<uint8_t, volume_op(false, ACC_I16, true)>(
                      a, stream)
                : (int)cudaErrorInvalidValue;
    case volume_op(true, ACC_I16, true):
      return u8 ? volume_launch_k<uint8_t, volume_op(true, ACC_I16, true)>(
                      a, stream)
                : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace i3dr
