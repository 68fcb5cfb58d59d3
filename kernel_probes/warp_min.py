"""Probe of the warp minimum in every ``sgm_step`` user on the GPU: this
checkout against a copy of its package whose ``sgm_step`` takes the
five-shuffle butterfly (``lanes_min<WARP>``) in place of the warp's
hardware reduction, in turns (copy, this, this, copy), each in a process
of its own. Per root: ``census_fwd_kernel`` (``fused_census_horizontal``
at D = 64 and 128 on the SGBM scene, 1x1024x1280, CUDA events around one
call and 10 calls back to back) and the ``sgm_volume`` chain
(``sgm_aggregate``, 8 paths, D = 64 and 128, float32 costs and uint8
costs in int16 mode), and a digest of every output.

    python3 kernel_probes/warp_min.py    # from the repository root
"""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / "i3dr_stereo_tpu_torch" / "_kernels" / "probes" / "butterfly"


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as cs
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
    from i3dr_stereo_tpu_torch.ops import sgm
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    assert str(root) in _build.__file__, _build.__file__
    _build.library()
    out = {"root": root.name, "card": cs.card_line()}
    sc = layered_scene(cs.H_SGBM, cs.W_SGBM, **cs.SGBM_SCENE)
    img = lambda a: torch.tensor(cs.raw_u8(a), device="cuda").float()[None]
    cl = fcs.census_word_planes(census_transform(img(sc.left), 9, 9))
    cr = fcs.census_word_planes(census_transform(img(sc.right), 9, 9))
    base = torch.zeros((cs.H_SGBM // 8,), dtype=torch.int32, device="cuda")
    for D in (64, 128):
        call = lambda: fcs.fused_census_horizontal(cl, cr, base, D, 10.0, 120.0)
        out[f"census_fwd_D{D}_ms"] = cs.gpu_ms(call)
        out[f"census_fwd_D{D}_b2b_ms"] = cs.back_to_back_ms(call, iters=10)
        out[f"census_fwd_D{D}_digest"] = digest(*call())
    del cl, cr
    g = torch.Generator(device="cuda").manual_seed(7)
    for D in (64, 128):
        C = torch.rand((1, cs.H_SGBM, cs.W_SGBM, D), generator=g,
                       device="cuda") * 60
        C[torch.rand(C.shape, generator=g, device="cuda") < 0.03] = 1e9
        Cu = torch.where(C > 1e8, 255.0, C.round()).to(torch.uint8)
        for name, vol, od in (("f32", C, None), ("u8_i16", Cu, torch.int16)):
            agg = lambda: sgm.sgm_aggregate(vol, 200.0, 400.0,
                                            sgm.DIRECTIONS_8, out_dtype=od)
            out[f"volume_{name}_D{D}_ms"] = cs.gpu_ms(agg)
            out[f"volume_{name}_D{D}_digest"] = digest(agg())
        del C, Cu
        torch.cuda.empty_cache()
    return out


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(REPO / "i3dr_stereo_tpu_torch",
                    COPY / "i3dr_stereo_tpu_torch",
                    ignore=shutil.ignore_patterns("_kernels", "__pycache__"))
    step = COPY / "i3dr_stereo_tpu_torch" / "csrc" / "sgm_step.cuh"
    text = step.read_text()
    assert "const float m = warp_min(lm);" in text
    step.write_text(text.replace("const float m = warp_min(lm);",
                                 "const float m = lanes_min<WARP>(lm);"))


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(measure(Path(sys.argv[2]).resolve())),
              flush=True)
        return 0
    make_copy()
    results = []
    for root in (COPY, REPO, REPO, COPY):
        run = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], flush=True)
            return 1
        res = json.loads([l for l in run.stdout.splitlines()
                          if l.startswith("RESULT ")][-1][7:])
        res["root"] = "butterfly" if root == COPY else "hardware"
        print(json.dumps(res), flush=True)
        results.append(res)
    digests = [k for k in results[0] if k.endswith("_digest")]
    equal = all(len({r[k] for r in results}) == 1 for k in digests)
    print(f"digests equal across the roots: {equal}", flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
