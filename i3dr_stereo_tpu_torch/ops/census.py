"""Census transform (torch port of ``i3dr_stereo_tpu.ops.census``).

The matching cost of the flagship I3DRSGM engine (``Feature Set =
census``, 9x9 window, ini/quick.param:99,105-106): 80 neighbour
comparisons packed into 3 32-bit words per pixel. Plain torch on every
device; the hamming cost over these words is the ``census_cost`` kernel
(:mod:`i3dr_stereo_tpu_torch.ops.sgm_fused_t`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_offsets(h: int, w: int):
    if h % 2 != 1 or w % 2 != 1:
        raise ValueError(f"census window must be odd, got {h}x{w}")
    return [(dy, dx)
            for dy in range(-(h // 2), h // 2 + 1)
            for dx in range(-(w // 2), w // 2 + 1)
            if not (dy == 0 and dx == 0)]


def census_transform(image: torch.Tensor, height: int = 9,
                     width: int = 9) -> torch.Tensor:
    """(B, H, W) or (H, W) image -> (..., H, W, n_words) int32 census words.

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
