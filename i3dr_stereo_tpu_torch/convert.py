"""Carry configuration and calibration across from the JAX package.

The port keeps its own copies of the framework-free config and camera
classes (importing any ``i3dr_stereo_tpu`` module imports JAX). These
helpers turn the reference package's objects (matcher config, pyramid
profile, rig, TSDF volume) into the port's by reading
plain attributes and numpy arrays — duck-typed, so this module imports
nothing of the JAX package — letting both sides compute from identical
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from i3dr_stereo_tpu_torch.config.params import (
    Algorithm,
    CostFunction,
    MatcherConfig,
)
from i3dr_stereo_tpu_torch.config.profile import PyramidLevelConfig, SGMProfile
from i3dr_stereo_tpu_torch.core.camera import CameraModel, StereoRig
from i3dr_stereo_tpu_torch.mapping.tsdf import TSDFVolume, to_device


def config_from_reference(cfg) -> MatcherConfig:
    """The port's MatcherConfig with every field of the reference ``cfg``."""
    kw = {}
    for f in dataclasses.fields(MatcherConfig):
        v = getattr(cfg, f.name)
        if f.name == "algorithm":
            v = Algorithm(int(v))
        elif f.name == "cost":
            v = CostFunction(v.value)
        kw[f.name] = v
    return MatcherConfig(**kw)


def profile_from_reference(profile) -> SGMProfile:
    """The port's SGMProfile with every field of the reference ``profile``
    and of each of its levels."""
    levels = tuple(
        PyramidLevelConfig(**{f.name: getattr(lv, f.name)
                              for f in dataclasses.fields(PyramidLevelConfig)})
        for lv in profile.levels)
    kw = {f.name: getattr(profile, f.name)
          for f in dataclasses.fields(SGMProfile) if f.name != "levels"}
    return SGMProfile(levels=levels, **kw)


def _camera_from_reference(cam) -> CameraModel:
    return CameraModel(
        width=int(cam.width), height=int(cam.height),
        K=np.array(cam.K, dtype=np.float64), D=np.array(cam.D, dtype=np.float64),
        R=np.array(cam.R, dtype=np.float64), P=np.array(cam.P, dtype=np.float64))


def rig_from_reference(rig) -> StereoRig:
    """The port's StereoRig with the reference rig's calibration."""
    return StereoRig(_camera_from_reference(rig.left),
                     _camera_from_reference(rig.right))


def lean_from_backend(backend: str) -> bool:
    """The port's ``lean`` argument for the reference's SGM backend name
    (its ``I3DR_SGM_BACKEND``): the lean fused path for ``pallas`` and
    ``pallas_interpret``, the default path for ``pallas_t`` and
    ``pallas_t_interpret``. The reference's ``xla`` and ``auto`` name no
    path of the port and raise."""
    if backend in ("pallas", "pallas_interpret"):
        return True
    if backend in ("pallas_t", "pallas_t_interpret"):
        return False
    raise ValueError(f"the port has no counterpart of SGM backend "
                     f"{backend!r}: expected pallas, pallas_interpret, "
                     f"pallas_t or pallas_t_interpret")


def tsdf_from_reference(volume, device="cuda") -> TSDFVolume:
    """The port's TSDFVolume on ``device`` holding the reference
    ``volume``'s map: its ``shape``, ``voxel_size``, ``origin``,
    ``trunc_vox``, ``tsdf``, ``weight`` and ``frames_integrated``, read as
    numpy (copies), so a map started by the JAX package can be continued
    here."""
    vol = TSDFVolume(shape=tuple(int(s) for s in volume.shape),
                     voxel_size=float(volume.voxel_size),
                     origin=tuple(float(o) for o in volume.origin),
                     trunc_vox=int(volume.trunc_vox), device=device)
    for name in ("tsdf", "weight"):
        arr = np.array(getattr(volume, name), dtype=np.float32)
        if arr.shape != vol.tsdf.shape:
            raise ValueError(f"tsdf_from_reference: {name} has shape "
                             f"{arr.shape}, the volume {vol.tsdf.shape}")
        setattr(vol, name, to_device(arr, vol.device).contiguous())
    vol.frames_integrated = int(volume.frames_integrated)
    return vol
