"""Torch port: the engine profile (``config/profile.py``, INI parser and
typed schedule) against the JAX package's, field for field, through
``convert.profile_from_reference``. Everything here is exact: the port's
module is a copy of the reference's host code."""

import dataclasses

import pytest

from i3dr_stereo_tpu.config import profile as ref
from i3dr_stereo_tpu_torch.config import profile as port
from i3dr_stereo_tpu_torch.convert import profile_from_reference

# an engine .param file in the reference's dialect: comments, blank and
# CRLF lines, spaces in keys, a duplicate section that merges, a subpix
# section, per-direction penalties and flags, a level turned off
INI = """\
# I3DRSGM engine profile
; written by a test
[Parameter]
Pyramid Levels = 3
Top Prediction Shift = -3

[Pyramid 2]
Number Of Disparities = 41
Feature Set Size X = 7
Feature Set Size Y = 5
SN Penalty 1 = 0.2
SE-NW Penalty 1 = 0.3
SW-NE Penalty 2 = 1.1
WE Penalty 2 = 0.9
SGM SouthWest-NorthEast Optimization = false
Disparity Speckle Filter Max Difference = 0.75
Disparity Speckle Filter Max Region Size = 64.0
Maximum Backmatching Distance = 2.5
DSI Interpolator = Linear\r
Interpolator Mode = WLS
Interpolator Number Of Directions = 16
Interpolator Minimum Number Of Elements = 3
Occlusion Detection = TRUE
Interpolate Occlusions = no

[Pyramid 1]
Process This Pyramid = 0
Compute Backmatching = false

[Pyramid 1]
Disparity Median Optimizer = off

[Pyramid 0]
Use CPU SGM = yes
Disparity Speckle Filter Optimizer = false
Interpolate Disparity = false
garbage line without an equals sign

[Pyramid 0 Subpix]
Disparity Step Size = 0.25
"""


def _assert_same(p, r):
    """Every field of the port's profile equals the reference's, with the
    same type (bool stays bool, an int stays an int)."""
    assert type(p).__name__ == type(r).__name__
    for f in dataclasses.fields(r):
        a, b = getattr(p, f.name), getattr(r, f.name)
        if f.name == "levels":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _assert_same(x, y)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


def test_dataclass_fields_match_reference():
    for p_cls, r_cls in ((port.PyramidLevelConfig, ref.PyramidLevelConfig),
                         (port.SGMProfile, ref.SGMProfile)):
        pf, rf = dataclasses.fields(p_cls), dataclasses.fields(r_cls)
        assert [(f.name, f.default) for f in pf] == \
            [(f.name, f.default) for f in rf]
    assert (port.NODATA_VALUE, port.DSI_NODATA) == \
        (ref.NODATA_VALUE, ref.DSI_NODATA)


def test_ini_parser_on_text():
    got = port.parse_param_ini(INI)
    assert got == ref.parse_param_ini(INI)
    assert got["Pyramid 1"] == {"Process This Pyramid": "0",
                                "Compute Backmatching": "false",
                                "Disparity Median Optimizer": "off"}
    assert got["Pyramid 2"]["DSI Interpolator"] == "Linear"


def test_load_param_file_and_from_param_file(tmp_path):
    path = tmp_path / "engine.param"
    path.write_bytes(INI.encode() + b"\xff\xfe trailing bytes\n")
    assert port.load_param_file(str(path)) == ref.load_param_file(str(path))
    _assert_same(port.SGMProfile.from_param_file(str(path)),
                 ref.SGMProfile.from_param_file(str(path)))
    named = port.SGMProfile.from_param_file(str(path), name="mine")
    assert named.name == "mine"


@pytest.mark.parametrize("text", ["", "  true ", "1", "Yes", "ON", "false",
                                  "0", "no", "off", "maybe"])
def test_to_bool(text):
    assert port._to_bool(text) is ref._to_bool(text)


def test_from_sections_field_for_field():
    secs = ref.parse_param_ini(INI)
    got = port.SGMProfile.from_sections("engine", secs)
    _assert_same(got, ref.SGMProfile.from_sections("engine", secs))
    # coarse -> fine, the subpix pass after its level; the top shift on the
    # coarsest level only
    assert [(lv.level, lv.subpix_pass) for lv in got.levels] == \
        [(2, False), (1, False), (0, False), (0, True)]
    assert [lv.prediction_shift for lv in got.levels] == [-3.0, 0.0, 0.0,
                                                          0.0]
    assert got.use_cpu is True
    lv2 = got.levels[0]
    assert lv2.p1 == (0.2, 0.3, 0.1, 0.1)
    assert lv2.p2 == (0.8, 0.8, 1.1, 0.9)
    assert lv2.directions == (True, True, False, True)
    assert lv2.speckle_max_region == 64 and lv2.interpolator_mode == "wls"
    assert [lv.level for lv in got.enabled_levels] == [2, 0, 0]


def test_from_sections_defaults():
    _assert_same(port.SGMProfile.from_sections("empty", {}),
                 ref.SGMProfile.from_sections("empty", {}))
    one = {"Pyramid 0": {}}
    _assert_same(port.PyramidLevelConfig.from_section(
        0, one["Pyramid 0"], subpix_pass=False, top_shift=2.0),
        ref.PyramidLevelConfig.from_section(
            0, one["Pyramid 0"], subpix_pass=False, top_shift=2.0))


@pytest.mark.parametrize("make", ["quick_profile", "subpix_profile"])
def test_builtin_profiles_field_for_field(make):
    got = getattr(port, make)()
    want = getattr(ref, make)()
    _assert_same(got, want)
    _assert_same(profile_from_reference(want), want)
    assert got == profile_from_reference(want)


@pytest.mark.parametrize("lo,hi", [(0, 5), (2, 4), (3, 3), (0, 0), (6, 9)])
def test_with_levels_enabled(lo, hi):
    for make in ("quick_profile", "subpix_profile"):
        got = getattr(port, make)().with_levels_enabled(lo, hi)
        _assert_same(got, getattr(ref, make)().with_levels_enabled(lo, hi))
        # subpix passes keep their own switch
        assert all(lv.enabled for lv in got.levels if lv.subpix_pass)


@pytest.mark.parametrize("kw", [
    dict(p1=100.0, p2=800.0, disparity_range=528, speckle_range=5.0,
         min_disparity=400.0),
    dict(p1=100.0, p2=3000.0, subpix=True),
    dict(disparity_range=310),
    dict(disparity_range=29, min_disparity=-60.0),
    dict(),
])
def test_from_ros_convention(kw):
    got = port.from_ros_convention(**kw)
    want = ref.from_ros_convention(**kw)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


def test_profile_from_reference_carries_every_field():
    secs = ref.parse_param_ini(INI)
    want = dataclasses.replace(ref.SGMProfile.from_sections("x", secs),
                               nodata=-1.0, dsi_nodata=5.0)
    got = profile_from_reference(want)
    _assert_same(got, want)
    assert isinstance(got, port.SGMProfile)
    assert all(isinstance(lv, port.PyramidLevelConfig) for lv in got.levels)
