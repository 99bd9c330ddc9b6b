"""Image packing and file output.

The counterpart of ``uob_raytracer_tpu/ops/image.py``: the ARGB8888 packing
of ``color_pixel`` (``Source/kernels.cl:37-40``) and a BMP writer with the
same byte layout as ``SDL_SaveImage`` (``Source/SDLauxiliary.h:24-54``).
"""
from __future__ import annotations

import struct

import numpy as np
import torch


def to_u8(img):
    """float [..,3] -> uint8 RGB, trunc(clamp(255*c, 0, 255))."""
    return torch.clamp(255.0 * img, 0.0, 255.0).to(torch.uint8)


def pack_argb(img):
    """float [.., 3] -> uint32 ARGB8888, trunc(clamp(255*c, 0, 255)), alpha
    255 — exactly ``color_pixel`` (``kernels.cl:37-40``). Packed in int64
    (torch has no shifts on uint32) and returned as ``torch.uint32``."""
    rgb = torch.clamp(255.0 * img, 0.0, 255.0).to(torch.int64)
    packed = ((255 << 24) + (rgb[..., 0] << 16) + (rgb[..., 1] << 8)
              + rgb[..., 2])
    return packed.to(torch.uint32)


def save_bmp(path: str, packed) -> None:
    """Write a packed ARGB8888 uint32 image [H, W] (tensor or array) as a
    32-bpp BMP (BITMAPINFOHEADER, BI_RGB, bottom-up rows). The little-endian
    byte order of each pixel is B,G,R,A — the layout SDL_SaveBMP produces
    for the reference's screen buffer."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed, dtype="<u4")
    h, w = packed.shape
    img_bytes = packed[::-1].tobytes()  # bottom-up
    file_header = struct.pack("<2sIHHI", b"BM", 14 + 40 + len(img_bytes), 0, 0, 54)
    info_header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 32, 0,
                              len(img_bytes), 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(file_header)
        f.write(info_header)
        f.write(img_bytes)


def save_ppm(path: str, img) -> None:
    """Write a float image [H, W, 3] (tensor or array) as binary PPM."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    u8 = np.clip(255.0 * np.asarray(img, dtype=np.float32), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (u8.shape[1], u8.shape[0]))
        f.write(u8.tobytes())
