"""Census transform (torch port of ``i3dr_stereo_tpu.ops.census``).

The matching cost of the flagship I3DRSGM engine (``Feature Set =
census``, 9x9 window, ini/quick.param:99,105-106): 80 neighbour
comparisons packed into 3 32-bit words per pixel. On a CUDA tensor
:func:`census_transform` and :func:`census_transform_pair` (a level's two
images in one launch) run the ``census_transform`` kernel
(``csrc/census_transform.cu``; the reference's census is an XLA fusion,
not a Pallas kernel); on a CPU tensor, or with ``plain=True``, the plain
torch twin :func:`census_transform_plain`. The flagship's hamming cost
over these words is the ``census_cost`` kernel
(:mod:`i3dr_stereo_tpu_torch.ops.sgm_fused_t`); the dense matchers'
float32 volume is :func:`census_cost_volume`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.sgm_fused_t import _popcount32

BIG_COST = 1.0e9


def _window_offsets(h: int, w: int):
    if h % 2 != 1 or w % 2 != 1:
        raise ValueError(f"census window must be odd, got {h}x{w}")
    return [(dy, dx)
            for dy in range(-(h // 2), h // 2 + 1)
            for dx in range(-(w // 2), w // 2 + 1)
            if not (dy == 0 and dx == 0)]


def census_transform_plain(image: torch.Tensor, height: int = 9,
                           width: int = 9) -> torch.Tensor:
    """Plain torch twin of the ``census_transform`` kernel: (B, H, W) or
    (H, W) image -> (..., H, W, n_words) int32 census words.

    Same bits as the JAX reference: neighbours in row-major order with
    the centre skipped, bit ``i`` of word ``i // 32`` set when neighbour
    ``i`` is strictly greater than the centre, edge-replicated borders.
    torch's uint32 supports few operators, so the words are built in
    int64 and returned as int32 tensors holding the raw 32-bit patterns
    (``.view(torch.uint32)`` / numpy ``.view(np.uint32)`` recovers them).
    """
    batched = image.ndim == 3
    img = (image if batched else image[None]).to(torch.float32)
    ph, pw = height // 2, width // 2
    B, H, W = img.shape
    padded = F.pad(img[:, None], (pw, pw, ph, ph), mode="replicate")[:, 0]

    words = []
    word = torch.zeros((B, H, W), dtype=torch.int64, device=img.device)
    bit_idx = 0
    for dy, dx in _window_offsets(height, width):
        nb = padded[:, dy + ph:dy + ph + H, dx + pw:dx + pw + W]
        word |= (nb > img).to(torch.int64) << bit_idx
        bit_idx += 1
        if bit_idx == 32:
            words.append(word)
            word = torch.zeros_like(word)
            bit_idx = 0
    if bit_idx:
        words.append(word)
    out = torch.stack(words, dim=-1)
    # two's-complement reinterpretation of the low 32 bits
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    return out if batched else out[0]


def _census_kernel(images, height: int, width: int) -> tuple:
    """One launch of the ``census_transform`` kernel over one image or two
    of one shape (each (B, H, W) or (H, W)); raises on a tensor that is
    not on the card. Two images' words share one allocation."""
    if height % 2 != 1 or width % 2 != 1:
        raise ValueError(f"census window must be odd, got {height}x{width}")
    batched = images[0].ndim == 3
    xs = [(x if batched else x[None]).to(torch.float32).contiguous()
          for x in images]
    _build.require_cuda(*xs)
    B, H, W = xs[0].shape
    n_words = (height * width - 1 + 31) // 32
    outs = torch.empty((len(xs), B, H, W, n_words), dtype=torch.int32,
                       device=xs[0].device)
    out = outs.data_ptr()
    pair = len(xs) == 2
    _build.launch("i3dr_census_transform", "census_transform", xs[0].device,
                  xs[0].data_ptr(), xs[1].data_ptr() if pair else None, out,
                  out + 4 * B * H * W * n_words if pair else None, B, H, W,
                  height, width, _build.stream_of(xs[0]))
    return (outs if batched else outs[:, 0]).unbind(0)


def census_transform(image: torch.Tensor, height: int = 9, width: int = 9,
                     *, plain: bool = False) -> torch.Tensor:
    """(B, H, W) or (H, W) image -> (..., H, W, n_words) int32 census words
    (the bits of :func:`census_transform_plain`). A CPU tensor, or
    ``plain=True``, runs the twin; a CUDA tensor launches the kernel or
    raises."""
    if plain or image.device.type == "cpu":
        return census_transform_plain(image, height, width)
    return _census_kernel([image], height, width)[0]


def census_transform_pair(left: torch.Tensor, right: torch.Tensor,
                          height: int = 9, width: int = 9, *,
                          plain: bool = False):
    """:func:`census_transform` of a level's left and (warped) right image,
    which share a shape: one kernel launch for both."""
    if left.shape != right.shape:
        raise ValueError(f"census_transform_pair: shapes {tuple(left.shape)} "
                         f"and {tuple(right.shape)} differ")
    if plain or (left.device.type == "cpu" and right.device.type == "cpu"):
        return (census_transform_plain(left, height, width),
                census_transform_plain(right, height, width))
    return _census_kernel([left, right], height, width)


def census_cost_volume(left_census: torch.Tensor, right_census: torch.Tensor,
                       min_disparity: int, disparity_range: int):
    """Hamming cost volume of (B, H, W, NW) census words: ((B, H, W, D)
    float32, valid), valid the in-image mask of each (x, d) pairing (right
    pixel x - min_disparity - d inside the image); BIG_COST where invalid.
    One disparity plane at a time, so no (B, H, W, D, NW) gather is held."""
    B, H, W, _ = left_census.shape
    dev = left_census.device
    src = (torch.arange(W, device=dev)[:, None]
           - torch.arange(disparity_range, device=dev) - int(min_disparity))
    valid = (src >= 0) & (src < W)                              # (W, D)
    C = torch.empty((B, H, W, disparity_range), dtype=torch.float32,
                    device=dev)
    for d in range(disparity_range):
        x = left_census ^ right_census[:, :, src[:, d].clamp(0, W - 1)]
        ham = _popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(-1)
        C[..., d] = torch.where(valid[:, d], ham.to(torch.float32), BIG_COST)
    return C, valid.expand(B, H, W, disparity_range)
