"""Service request/response types, mirroring srv/*.srv.

srv/SaveStereo.srv: folderpath, save_rectified, save_disparity,
save_point_cloud -> res. srv/SaveRectified.srv: folderpath -> res.
srv/SetInt.srv, srv/SetFloat.srv: value -> res.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SaveStereoRequest:
    folderpath: str
    save_rectified: bool = True
    save_disparity: bool = True
    save_point_cloud: bool = True


@dataclasses.dataclass
class SaveStereoResponse:
    res: str = ""
    ok: bool = True
    paths: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SaveRectifiedRequest:
    folderpath: str


@dataclasses.dataclass
class SaveRectifiedResponse:
    res: str = ""
    ok: bool = True
    paths: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SetIntRequest:
    value: int


@dataclasses.dataclass
class SetFloatRequest:
    value: float


@dataclasses.dataclass
class SetResponse:
    res: str = ""
    ok: bool = True
