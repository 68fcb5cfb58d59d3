"""Matcher backends keyed by the reference's algorithm enum (torch port of
``i3dr_stereo_tpu.matchers.registry``).

Only the flagship — I3DRSGM with the coarse-to-fine pyramid — is ported.
Every other backend raises ``NotImplementedError`` naming the ROADMAP.md
item that ports it.
"""

from __future__ import annotations

from i3dr_stereo_tpu_torch.config.params import Algorithm, MatcherConfig
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match


def i3drsgm_match(left, right, cfg: MatcherConfig) -> MatchResult:
    """Census SGM with the engine's pyramid schedule (cfg.pyramid)."""
    if not cfg.pyramid:
        raise NotImplementedError(
            "dense (pyramid=False) I3DRSGM is not ported yet "
            "(ROADMAP.md Queue 1 item 11)")
    return pyramid_sgm_match(left, right, cfg)


def _not_ported(item: str):
    def match(left, right, cfg: MatcherConfig):
        raise NotImplementedError(
            f"{cfg.algorithm.name} is not ported yet (ROADMAP.md {item})")
    return match


MATCHER_REGISTRY = {
    Algorithm.BM: _not_ported("Queue 1 item 11"),
    Algorithm.SGBM: _not_ported("Queue 1 item 11"),
    Algorithm.I3DRSGM: i3drsgm_match,
    Algorithm.BM_GPU: _not_ported("Queue 1 item 11"),
    Algorithm.BP_GPU: _not_ported("Queue 1 item 12"),
    Algorithm.CSBP_GPU: _not_ported("Queue 1 item 12"),
}
