"""The recordings a traffic mix asks for, rendered from the seed.

Each base clip is a static texture of N(0, sd) over a grey background with
Gaussian blobs moving by the law of the repository's benchmark clip: blob
centre x = w x_frac + ax e^(-decay t) sin(2 pi hz t), y = h y_frac +
ay e^(-decay t) cos(2 pi hz y_ratio t), amplitude amp, widths sx, sy; the
sum is clipped to [0, 255] and truncated to uint8.  Every texture of a
pool comes from one generator on the device seeded with ``--seed``, in one
call; the frames are rendered on the device and copied to the host once,
as the decoded frames a user's decoder would hand over.

A recording plays its base ``"straight"`` (its frames once) or
``"pingpong"`` (forward and back, 0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...,
so that no pair jumps) to ``frames`` frames; frame i is at i / fps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RENDER_DEFAULTS = dict(background=40.0, texture_sd=6.0, amp=150.0, sx=30.0, sy=26.0, ax=40.0,
                       ay=18.0, decay=0.05, y_ratio=2.9 / 3.0, y_frac=0.5)
# Frames rendered per device call.
_BLOCK = 32


def render_pool(render: dict, n_bases: int, h: int, w: int, fps: float, seed: int,
                device) -> list:
    """``n_bases`` base clips (frames, h, w) uint8 on the host."""
    r = dict(RENDER_DEFAULTS, **render)
    n = int(r["frames"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tex = torch.randn((n_bases, h, w), generator=gen, device=device) * r["texture_sd"]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    t = torch.arange(n, device=device, dtype=torch.float64) / fps
    env = torch.exp(-r["decay"] * t)
    out = []
    for b in range(n_bases):
        clip = np.empty((n, h, w), np.uint8)
        for s in range(0, n, _BLOCK):
            img = (r["background"] + tex[b])[None].expand(min(_BLOCK, n - s), h, w).clone()
            for blob in r["blobs"]:
                ts, es = t[s:s + _BLOCK], env[s:s + _BLOCK]
                cx = w * blob["x_frac"] + r["ax"] * es * torch.sin(2 * math.pi * blob["hz"] * ts)
                cy = h * blob.get("y_frac", r["y_frac"]) + r["ay"] * es * torch.cos(
                    2 * math.pi * blob["hz"] * r["y_ratio"] * ts)
                cx = cx.float()[:, None, None]
                cy = cy.float()[:, None, None]
                img += r["amp"] * torch.exp(-((xx - cx) / r["sx"]) ** 2 - ((yy - cy) / r["sy"]) ** 2)
            clip[s:s + len(img)] = img.clamp_(0, 255).to(torch.uint8).cpu().numpy()
        out.append(clip)
    return out


def play_index(playback: str, n_base: int, n_frames: int) -> np.ndarray:
    """Base frame shown at each recording frame."""
    i = np.arange(n_frames)
    if playback == "straight":
        if n_frames != n_base:
            raise ValueError(f"a straight recording has its base's {n_base} frames")
        return i
    if playback == "pingpong":
        period = 2 * (n_base - 1)
        j = i % period
        return np.minimum(j, period - j)
    raise ValueError(f"unknown playback {playback!r}")
